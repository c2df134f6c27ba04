"""Optimizers and epoch-based learning-rate schedules.

Counterpart of ``sinnerf_tpu/train/optimizers.py`` (reference
``utils/__init__.py:11-52`` and ``utils/warmup_scheduler.py``).  The
schedule is the pure function ``lr_for_epoch(hparams, epoch)``; the trainer
feeds its value into the optimizer with ``set_lr`` once per epoch.

``adam`` and ``sgd`` are ``torch.optim``'s, whose ``weight_decay`` is the
coupled L2 the reference uses (added to the gradient before the moment
updates).  ``radam`` and ``ranger`` (the reference's vendored RAdam and
Ranger, ``utils/optimizers.py``) are the JAX package's optax chains written
as ``torch.optim.Optimizer``s: ``RAdam`` is optax's ``scale_by_radam``
(eps 1e-8 outside the root, rectified once rho_t >= 5) with the decoupled,
lr-scaled weight decay ``p -= lr * wd * p``; ``Ranger`` is RAdam at b1 0.95
plus a lookahead that every 6 steps pulls the weights halfway to slow
weights, which its ``state_dict`` carries (``slow_buffer`` beside each
parameter's moments and step count).  ``torch.optim.RAdam`` cannot serve
as the inner step: it adds eps to the root of the raw second moment, not of
the bias-corrected one, which moves steps whose gradients lie near eps
(``tests/test_torch_optimizers.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch


def lr_for_epoch(hparams: Any, epoch: float) -> float:
    """The absolute learning rate of ``epoch`` (before any optimizer ``rate``
    factor): ``steplr`` (MultiStepLR), ``cosine`` or ``poly``, after a
    GradualWarmupScheduler ramp when ``warmup_epochs > 0``
    (warmup_scheduler.py:25-35,53-61; off for radam and ranger as in
    utils/__init__.py:48-51)."""
    sched = getattr(hparams, "lr_scheduler", "steplr")
    num_epochs = getattr(hparams, "num_epochs", 1)
    warmup_epochs = getattr(hparams, "warmup_epochs", 0)
    optimizer = getattr(hparams, "optimizer", "adam")
    warmup_on = warmup_epochs > 0 and optimizer not in ("radam", "ranger")
    mult = getattr(hparams, "warmup_multiplier", 1.0)
    if warmup_on and epoch <= warmup_epochs:
        return hparams.lr * (1.0 + (mult - 1.0) * epoch / warmup_epochs)

    lr = hparams.lr * (mult if warmup_on else 1.0)
    # the after-scheduler takes its first step one epoch after the ramp ends
    eff = epoch - warmup_epochs - 1 if warmup_on else epoch
    if sched == "steplr":
        gamma = getattr(hparams, "decay_gamma", 0.1)
        steps = getattr(hparams, "decay_step", [20])
        lr = lr * gamma ** sum(1 for s in steps if eff >= s)
    elif sched == "cosine":
        eta_min = 1e-8
        lr = eta_min + (lr - eta_min) * 0.5 * (1 + math.cos(math.pi * min(eff, num_epochs) / num_epochs))
    elif sched == "poly":
        exp = getattr(hparams, "poly_exp", 0.9)
        lr = lr * (1 - min(eff, num_epochs) / num_epochs) ** exp
    else:
        raise ValueError(f"unknown scheduler {sched!r}")
    return lr


class RAdam(torch.optim.Optimizer):
    """Rectified Adam as optax's ``scale_by_radam`` -> decoupled weight
    decay -> ``-lr`` (JAX ``get_optimizer``'s ``radam`` chain,
    ``train/optimizers.py:72-162``).  Per step t: the moments
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, their
    bias-corrected ``m^``, ``v^``, and
    ``rho_t = rho_inf - 2 t b2^t / (1 - b2^t)``; the update is
    ``r_t m^ / (sqrt(v^) + eps)`` once ``rho_t >= 5`` (``r_t`` the
    rectifier), else ``m^``; then ``p -= lr * (update + wd * p)``.

    ``b1^t``, ``b2^t``, ``rho_t`` and ``r_t`` are host scalars formed in
    float32 in optax's order of operations, ``b^t`` rounded once from the
    float32 ``b``, as the JAX trainer's jitted update forms them: near the
    switch ``2 t b2^t / (1 - b2^t)`` cancels to about 3e-2 of ``rho_t``, so
    the exact float64 rectifier would move the step-6 update by ~1%."""

    RHO_THRESHOLD = 5.0  # optax's default, the reference's "rho_t > 5"

    def __init__(self, params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        if lr < 0.0 or eps < 0.0 or weight_decay < 0.0:
            raise ValueError(f"invalid RAdam lr {lr}, eps {eps} or weight_decay {weight_decay}")
        if not all(0.0 <= b < 1.0 for b in betas):
            raise ValueError(f"invalid RAdam betas {betas}")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))

    @staticmethod
    def power(b: float, t: int) -> np.float32:
        """``b^t`` in float32: the float32 ``b`` to the ``t``, rounded once."""
        return np.float32(float(np.float32(b)) ** t)

    @staticmethod
    def rectifier(t: int, b2: float):
        """``r_t`` as a float32 number, or None while ``rho_t`` is below
        RHO_THRESHOLD (optax ``scale_by_radam``)."""
        f = np.float32
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = RAdam.power(b2, t)
        rho = f(rho_inf) - f(2 * t) * b2t / (f(1.0) - b2t)
        if rho < RAdam.RHO_THRESHOLD:
            return None
        return np.sqrt((rho - f(4.0)) * (rho - f(2.0)) * f(rho_inf) / (f((rho_inf - 4.0) * (rho_inf - 2.0)) * rho))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if "step" not in state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * (g * g))
                m_hat = m / float(np.float32(1.0) - self.power(b1, t))
                r = self.rectifier(t, b2)
                if r is None:
                    update = m_hat
                else:
                    v_hat = v / float(np.float32(1.0) - self.power(b2, t))
                    update = float(r) * m_hat / (torch.sqrt(v_hat) + group["eps"])
                if group["weight_decay"] > 0.0:
                    update = update + group["weight_decay"] * p
                p.add_(update, alpha=-group["lr"])
        return loss


class Ranger(RAdam):
    """RAdam (b1 0.95) with a lookahead (JAX ``lookahead`` with k 6 and
    alpha 0.5, ``train/optimizers.py:72-110``): the slow weights start as the
    weights at construction, and after every k-th step both become
    ``slow + alpha * (fast - slow)``.  The step count that times the sync is
    RAdam's own, in each parameter's state beside ``slow_buffer``."""

    K, ALPHA = 6, 0.5

    def __init__(self, params, lr: float = 1e-3, betas: Tuple[float, float] = (0.95, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, betas, eps, weight_decay)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["slow_buffer"] = p.detach().clone()

    @torch.no_grad()
    def step(self, closure=None):
        loss = super().step(closure)
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                if "step" in state and state["step"] % self.K == 0:
                    slow = state["slow_buffer"]
                    slow.add_(self.ALPHA * (p - slow))
                    p.copy_(slow)
        return loss


def get_optimizer(hparams: Any, params: Iterable[torch.nn.Parameter], rate: float = 1.0) -> torch.optim.Optimizer:
    """The optimizer named by ``hparams.optimizer`` over ``params`` at
    ``hparams.lr * rate`` (the discriminator uses 0.2x,
    ``models/sinnerf.py:208``).  ``radam`` and ``ranger`` take eps 1e-8 and
    their own betas (the reference's ``get_optimizer`` sets only lr, eps and
    weight decay, ``utils/__init__.py:16-28``)."""
    name = getattr(hparams, "optimizer", "adam")
    wd = getattr(hparams, "weight_decay", 0.0)
    lr = hparams.lr * rate
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=getattr(hparams, "momentum", 0.9), weight_decay=wd)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if name == "radam":
        return RAdam(params, lr=lr, eps=1e-8, weight_decay=wd)
    if name == "ranger":
        return Ranger(params, lr=lr, eps=1e-8, weight_decay=wd)
    raise ValueError(f"optimizer not recognized: {name}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float, rate: float = 1.0) -> torch.optim.Optimizer:
    """Feed the scheduled learning rate into every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr * rate
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def load_adam_moments(
    optimizer: torch.optim.Adam,
    named_params: Dict[str, torch.nn.Parameter],
    mu: Dict[str, Any],
    nu: Dict[str, Any],
    count: int,
) -> None:
    """Write first and second moments (name -> array in the parameter's
    layout, e.g. an optax ``ScaleByAdamState``'s ``mu`` and ``nu`` carried
    across by ``models.nerf.state_dict_from_jax``) and the step count into a
    ``torch.optim.Adam``'s ``exp_avg``, ``exp_avg_sq`` and ``step``."""
    for name, p in named_params.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(np.asarray(mu[name]), dtype=p.dtype, device=p.device).clone(),
            "exp_avg_sq": torch.as_tensor(np.asarray(nu[name]), dtype=p.dtype, device=p.device).clone(),
        }
