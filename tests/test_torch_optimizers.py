"""The port's ``radam`` and ``ranger`` against the JAX package's optax chains
(``sinnerf_tpu/train/optimizers.py:72-162``) on the CPU.

Both step the same parameters on the same gradients for 13 steps: across
RAdam's switch to the rectified update (rho_t >= 5 from step 6) and two of
Ranger's lookahead syncs (steps 6 and 12), with and without weight decay,
the learning rate fed per step by ``set_lr``.  The gradients span 1e-9 to
10, so some lie below eps.  The optax update runs under ``jax.jit``, as the
JAX trainer's ``train_step`` runs it; the port's optimizer is the one
``get_optimizer`` returns.  Every parameter (and Ranger's slow weights) is
held at rtol 1e-6, atol 1e-7.

optax forms rho_t in float32, where ``2 t b2^t / (1 - b2^t)`` cancels: its
rectifier differs from the exact float64 one by up to 1.2% (step 6), so the
port forms it in float32 as optax does; ``test_rectifier_matches_optax``
holds it to jitted optax's over 5000 steps.
"""

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sinnerf_tpu.train import optimizers as jax_optimizers
from sinnerf_tpu_torch.train import optimizers as port_optimizers

STEPS = 13


def _hp(optimizer, weight_decay, lr=1e-3):
    return argparse.Namespace(optimizer=optimizer, lr=lr, weight_decay=weight_decay, lr_scheduler="steplr",
                              decay_step=[9], decay_gamma=0.5)


@jax.jit
def _optax_rho_r(count):
    """rho_t and the rectifier as ``optax.scale_by_radam`` forms them under
    ``jit`` (float32, b2 = 0.999 a Python float)."""
    b2 = 0.999
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = b2 ** count
    ro = ro_inf - 2 * count * b2t / (1 - b2t)
    return ro, jnp.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))


def _problem(seed=80):
    rng = np.random.default_rng(seed)
    p0 = {"a": rng.normal(size=(5, 7)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.uniform(-9, 1, size=v.shape)).astype(np.float32)
              for k, v in p0.items()} for _ in range(STEPS)]
    return p0, grads


def _lookahead_slow(state):
    found = [s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, jax_optimizers.LookaheadState))
             if isinstance(s, jax_optimizers.LookaheadState)]
    return found[0].slow if found else None


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_radam_and_ranger_match_optax(name, weight_decay):
    hp = _hp(name, weight_decay)
    p0, grads = _problem()
    opt = jax_optimizers.get_optimizer(hp)

    @jax.jit
    def jax_step(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jparams)
    named = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    popt = port_optimizers.get_optimizer(hp, list(named.values()))
    assert type(popt) is {"radam": port_optimizers.RAdam, "ranger": port_optimizers.Ranger}[name]
    for step, g in enumerate(grads):
        lr = jax_optimizers.lr_for_epoch(hp, step)
        jax_optimizers.set_lr(jstate, lr)
        jparams, jstate = jax_step({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        port_optimizers.set_lr(popt, port_optimizers.lr_for_epoch(hp, step))
        for k, p in named.items():
            p.grad = torch.tensor(g[k])
        popt.step()
        slow = _lookahead_slow(jstate)
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step + 1} {k}")
            assert popt.state[p]["step"] == step + 1
            if slow is not None:
                np.testing.assert_allclose(popt.state[p]["slow_buffer"].numpy(), np.asarray(slow[k]), rtol=1e-6,
                                           atol=1e-7, err_msg=f"slow, step {step + 1} {k}")
    moved = {k: float(np.abs(np.asarray(jparams[k]) - p0[k]).max()) for k in p0}
    assert min(moved.values()) > 1e-4, moved  # the steps moved the weights well past the tolerance


def test_rectifier_matches_optax():
    """The port's rectifier switches on at the same step as optax's (6, for
    b2 0.999) and equals jitted optax's in float32 over 5000 steps, to 2e-7
    (two steps of the 5000 differ, by one ulp, measured); the exact float64
    rectifier lies 1.2% away at step 6."""
    b2 = 0.999
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    steps = np.arange(1, 5001)
    optax_rho, optax_r = (np.asarray(a) for a in _optax_rho_r(jnp.asarray(steps, jnp.int32)))
    assert (optax_rho < 5.0).tolist() == (steps <= 5).tolist()
    got = [port_optimizers.RAdam.rectifier(int(t), b2) for t in steps]
    assert all(r is None for r in got[:5]) and all(isinstance(r, np.float32) for r in got[5:])
    ratios = np.asarray(got[5:], np.float64) / optax_r[5:].astype(np.float64)
    assert np.abs(ratios - 1.0).max() < 2e-7
    rho6 = ro_inf - 2.0 * 6 * b2 ** 6 / (1.0 - b2 ** 6)
    exact6 = np.sqrt((rho6 - 4.0) * (rho6 - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * rho6))
    assert abs(exact6 / float(got[5]) - 1.0) > 5e-3  # the float32 cancellation is real at the switch


def test_torch_radam_cannot_serve_as_the_inner_step():
    """``torch.optim.RAdam`` (decoupled weight decay, a float64 rectifier)
    adds eps to the root of the raw second moment: where the
    gradients lie near eps its steps differ from optax's and the port's by
    far more than the parity tolerance, while on large gradients they
    agree."""
    rng = np.random.default_rng(81)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    for scale, agree in ((1e-9, False), (1.0, True)):
        grads = [(rng.normal(size=p0.shape) * scale).astype(np.float32) for _ in range(8)]
        ours, theirs = torch.nn.Parameter(torch.tensor(p0)), torch.nn.Parameter(torch.tensor(p0))
        a = port_optimizers.RAdam([ours], lr=1e-3, eps=1e-8, weight_decay=1e-2)
        b = torch.optim.RAdam([theirs], lr=1e-3, eps=1e-8, weight_decay=1e-2, decoupled_weight_decay=True)
        for g in grads:
            ours.grad, theirs.grad = torch.tensor(g), torch.tensor(g)
            a.step()
            b.step()
        moved = ours.detach() - torch.tensor(p0)
        gap = float((ours - theirs).detach().abs().max() / moved.abs().max())
        assert (gap < 1e-4) == agree, (scale, gap)


def test_ranger_state_dict_resumes_exactly():
    """Ranger's ``state_dict`` carries each weight's moments, step count and
    slow weights: an optimizer that loads it mid-run, across a sync, steps as
    the one that ran on."""
    p0, grads = _problem(seed=82)

    def params():
        return [torch.nn.Parameter(torch.tensor(v)) for v in p0.values()]

    run = params()
    opt = port_optimizers.Ranger(run, lr=1e-3, weight_decay=1e-2)
    for g in grads[:4]:
        for p, k in zip(run, p0):
            p.grad = torch.tensor(g[k])
        opt.step()
    saved = copy.deepcopy(opt.state_dict())  # as a checkpoint holds it: not the live tensors
    assert set(saved["state"][0]) == {"step", "exp_avg", "exp_avg_sq", "slow_buffer"}
    resumed = [torch.nn.Parameter(p.detach().clone()) for p in run]
    opt2 = port_optimizers.Ranger(resumed, lr=1e-3, weight_decay=1e-2)
    opt2.load_state_dict(saved)
    for g in grads[4:10]:  # the sync at step 6
        for ps in (run, resumed):
            for p, k in zip(ps, p0):
                p.grad = torch.tensor(g[k])
        opt.step()
        opt2.step()
    for a, b in zip(run, resumed):
        assert torch.equal(a, b)
    assert opt2.state[resumed[0]]["step"] == 10


def test_get_optimizer_and_refusals():
    """``get_optimizer``'s radam and ranger: their betas (0.9, and Ranger's
    0.95 which the reference leaves at its default), eps 1e-8, lr * rate;
    invalid hyperparameters raise."""
    p = [torch.nn.Parameter(torch.zeros(3))]
    radam = port_optimizers.get_optimizer(_hp("radam", 1e-3, lr=5e-4), p, rate=0.2)
    ranger = port_optimizers.get_optimizer(_hp("ranger", 0.0, lr=5e-4), p)
    assert radam.param_groups[0]["betas"] == (0.9, 0.999) and ranger.param_groups[0]["betas"] == (0.95, 0.999)
    assert radam.param_groups[0]["lr"] == pytest.approx(1e-4) and radam.param_groups[0]["weight_decay"] == 1e-3
    assert radam.param_groups[0]["eps"] == ranger.param_groups[0]["eps"] == 1e-8
    assert (ranger.K, ranger.ALPHA) == (6, 0.5)
    for bad in (dict(lr=-1.0), dict(betas=(1.0, 0.999)), dict(eps=-1e-8), dict(weight_decay=-1.0)):
        with pytest.raises(ValueError):
            port_optimizers.RAdam(p, **bad)
