"""Optimizers and epoch-based learning-rate schedules.

Counterpart of ``sinnerf_tpu/train/optimizers.py`` (reference
``utils/__init__.py:11-52`` and ``utils/warmup_scheduler.py``).  The
schedule is the pure function ``lr_for_epoch(hparams, epoch)``; the trainer
feeds its value into the optimizer with ``set_lr`` once per epoch.

``adam`` and ``sgd`` are ``torch.optim``'s, whose ``weight_decay`` is the
coupled L2 the reference uses (added to the gradient before the moment
updates).  ``radam`` and ``ranger`` (the reference's vendored RAdam and its
Lookahead wrapper) are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable

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


def get_optimizer(hparams: Any, params: Iterable[torch.nn.Parameter], rate: float = 1.0) -> torch.optim.Optimizer:
    """The optimizer named by ``hparams.optimizer`` over ``params`` at
    ``hparams.lr * rate`` (the discriminator uses 0.2x,
    ``models/sinnerf.py:208``)."""
    name = getattr(hparams, "optimizer", "adam")
    wd = getattr(hparams, "weight_decay", 0.0)
    lr = hparams.lr * rate
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=getattr(hparams, "momentum", 0.9), weight_decay=wd)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if name in ("radam", "ranger"):
        raise NotImplementedError(
            f"optimizer {name!r} (the reference's vendored RAdam/Lookahead) is ported with the trainer "
            "in a later slice; use 'adam' or 'sgd'"
        )
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
