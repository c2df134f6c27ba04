"""The port's training render (K3) against the JAX train kernels, its plain
backward against autograd, and the CUDA kernels against the plain versions.

On the CPU ``fused_render_level_train`` runs its plain versions: the plain
forward and, in ``backward``, the explicit plain backward that follows the
kernel step by step.  Both are held against the JAX Pallas kernels
(``fused_render_train_t.fused_render_level_train``) in interpret mode and
``jax.grad`` through them, on the same numpy-seeded weights, rays, depths and
noise; each JAX reference is jitted once per module.

Tolerances.  float32 outputs: rtol 1e-4, atol 1e-5 (other summation orders in
13 products).  float32 gradients: 1e-2 of each leaf's largest entry: around
saturated alphas the 1e10 last interval makes the composite adjoint
ill-conditioned in float32, and JAX's own test of this kernel
(``tests/test_fused_mlp.py:367-383``) explains and uses the same band; and a
ReLU mask flips between the packages where a pre-activation lies within the
PE recurrence's ~1e-5 of zero (measured here: up to 5.7e-3).
bfloat16 outputs: 2e-2 (an activation can round to a neighbouring bf16
value); bfloat16 gradients: 1e-1 of each leaf's largest entry and 1e-1
relative L2: a flipped rounding or ReLU mask changes one unit's delta at one
point by its whole size, a few dozen rays average little of that, and JAX
sums its bias gradients in bf16 where the port sums in float32.  The plain
backward against autograd through the plain forward (float32, the same
arithmetic): 1e-5 relative L2.

Tests marked ``cuda`` build and launch the CUDA kernels and skip without a
card."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.ops.fused_render_train_t import fused_render_level_train as jax_train_render
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.ops import fused_render_train as frt
from sinnerf_tpu_torch.ops.fused_mlp import (
    BIAS_SIZE,
    PARAM_KEYS,
    WEIGHT_SIZE,
    pack_weights,
    param_tensors,
    torch_dtype,
    unpack_grads,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# (rays, samples, white_back, noise, compute dtype): ray counts that are no
# tile multiple, S = 12 is no multiple of 8
CASES = [(77, 12, False, True, "float32"), (40, 8, True, False, "float32"), (33, 16, True, True, "bfloat16")]


@pytest.fixture(scope="module")
def params():
    p = random_params(np.random.default_rng(51))
    p["sigma"]["b"] = p["sigma"]["b"] + np.float32(0.3)  # a partly opaque field
    return p


def _inputs(n, s, use_noise):
    rng = np.random.default_rng(1000 * n + s)
    o = rng.normal(scale=0.3, size=(n, 3))
    d = rng.normal(scale=0.3, size=(n, 3)) + [0.0, 0.0, -1.0]
    rays = np.concatenate([o, d], 1).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, size=(n, s)), axis=1).astype(np.float32)
    noise = rng.normal(size=(n, s)).astype(np.float32) if use_noise else None
    target = rng.uniform(size=(n, 3)).astype(np.float32)
    return rays, z, noise, target


def _loss(out, target, xp):
    """Touches all three outputs, as tests/test_fused_mlp.py:344-363 does."""
    rgb, depth, w = out
    return xp.sum((rgb - target) ** 2) + 0.1 * xp.sum(depth**2) + 0.01 * xp.sum(w**2)


@pytest.fixture(scope="module")
def jax_results(params):
    out = {}
    for n, s, white_back, use_noise, cd in CASES:
        rays, z, noise, target = _inputs(n, s, use_noise)

        def loss(p):
            res = jax_train_render(p, jnp.asarray(rays.T), jnp.asarray(z),
                                   None if noise is None else jnp.asarray(noise), True, white_back, cd)
            return _loss(res, jnp.asarray(target), jnp), res

        (_, res), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
        out[(n, s, white_back, use_noise, cd)] = (
            [np.asarray(r) for r in res], jax.tree_util.tree_map(np.asarray, grads))
    return out


def _port_render_and_grads(params, case, render=frt.fused_render_level_train):
    n, s, white_back, use_noise, cd = case
    rays, z, noise, target = (None if a is None else torch.from_numpy(a) for a in _inputs(n, s, use_noise))
    model = nerf_from_state(state_dict_from_jax(params))
    out = render(model, rays, z, noise, True, white_back, cd)
    _loss(out, target, torch).backward()
    return [o.detach().numpy() for o in out], {k: p.grad.numpy() for k, p in model.state_dict(keep_vars=True).items()}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-S{c[1]}-{c[4]}")
def test_train_render_matches_jax(params, jax_results, case):
    """Outputs of the port's wrapper on the CPU (plain forward) and the
    gradients its ``backward`` returns (explicit plain backward) against the
    JAX kernels and ``jax.grad`` through them."""
    got, got_grads = _port_render_and_grads(params, case)
    want, want_grads = jax_results[case]
    assert float(want[2].sum(1).max()) > 0.1, "the field must not be empty"
    f32 = case[4] == "float32"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4 if f32 else 2e-2, atol=1e-5 if f32 else 2e-2)
    want_grads = state_dict_from_jax(want_grads)
    assert set(got_grads) == set(want_grads)
    for name, w in want_grads.items():
        g, w = got_grads[name], w.numpy()
        assert np.abs(w).max() > 0, name
        scale = np.abs(w).max() + 1e-8
        tol = 1e-2 if f32 else 1e-1
        np.testing.assert_allclose(g / scale, w / scale, rtol=tol, atol=tol, err_msg=name)
        if not f32:
            assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-1, name


@pytest.mark.parametrize("white_back,use_noise", [(False, True), (True, False)])
def test_plain_backward_matches_autograd(params, white_back, use_noise):
    """The explicit plain backward against autograd through the plain
    forward, float32: the same arithmetic, so tight."""
    case = (77, 12, white_back, use_noise, "float32")
    out_a, grads_a = _port_render_and_grads(params, case)
    out_b, grads_b = _port_render_and_grads(params, case, render=frt.render_level_train_plain)
    for a, b in zip(out_a, out_b):
        np.testing.assert_array_equal(a, b)
    for name in grads_b:
        rel = np.linalg.norm(grads_a[name] - grads_b[name]) / np.linalg.norm(grads_b[name])
        assert rel < 1e-5, (name, rel)


def test_plain_forward_chunks_add_up(params):
    """More than one chunk of rays: the chunks are recomputed in the backward
    pass and their parameter gradients add up to the unchunked ones."""
    case = (77, 12, True, True, "float32")
    whole = _port_render_and_grads(params, case, render=frt.render_level_train_plain)
    chunked = _port_render_and_grads(
        params, case, render=lambda *a: frt.render_level_train_plain(*a, chunk=32))
    for a, b in zip(whole[0], chunked[0]):
        np.testing.assert_array_equal(a, b)
    for name in whole[1]:
        np.testing.assert_allclose(chunked[1][name], whole[1][name], rtol=1e-4, atol=1e-6)


def test_rays_depths_and_noise_get_no_gradient(params):
    """The wrapper detaches rays, depths and noise (the JAX wrapper stops
    their gradients, tests/test_fused_mlp.py:475-501); the parameters get
    theirs."""
    rays, z, noise, _ = (torch.from_numpy(a).requires_grad_() for a in _inputs(16, 8, True))
    model = nerf_from_state(state_dict_from_jax(params))
    rgb, depth, w = frt.fused_render_level_train(model, rays, z, noise * 3.0)
    (rgb.sum() + (rgb * depth[:, None]).sum() + w.sum()).backward()
    assert rays.grad is None and z.grad is None and noise.grad is None
    total = sum(float(p.grad.abs().sum()) for p in model.parameters())
    assert np.isfinite(total) and total > 0


def test_detached_parameters_get_no_gradient(params):
    rays, z, noise, _ = (torch.from_numpy(a) for a in _inputs(16, 8, True))
    model = nerf_from_state(state_dict_from_jax(params))
    out = frt.fused_render_level_train(model, rays, z, noise, detach_params=True)
    assert not any(o.requires_grad for o in out)


def test_bf16_gradients_pass_no_bf16_cast(params):
    """The parameter gradients come back in float32 at float32 precision: a
    gradient sent through a ``.to(bfloat16)`` node would carry at most 8
    significant bits."""
    _, grads = _port_render_and_grads(params, (33, 16, True, True, "bfloat16"))
    g = torch.from_numpy(grads["xyz_encoding_8.0.weight"])
    assert g.dtype == torch.float32
    assert not torch.equal(g, g.bfloat16().float())


def test_unpack_grads_inverts_the_packing(params):
    """``unpack_grads`` is the adjoint of ``pack_weights``: packing the
    parameters and unpacking the buffers gives the parameters back, and the
    padded columns are dropped."""
    model = nerf_from_state(state_dict_from_jax(params))
    packed = pack_weights(model, torch.float32)
    assert packed.w.shape == (WEIGHT_SIZE,) and packed.b.shape == (BIAS_SIZE,)
    back = unpack_grads(packed.w, packed.b)
    tensors = param_tensors(model)
    assert len(back) == len(tensors) == 2 * len(PARAM_KEYS)
    for a, b in zip(back, tensors):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_wrapper_checks_its_inputs(params):
    rays, z, noise, _ = (torch.from_numpy(a) for a in _inputs(16, 8, True))
    model = nerf_from_state(state_dict_from_jax(params))
    with pytest.raises(ValueError):
        frt.fused_render_level_train(model, rays, z, noise[:, :4])
    with pytest.raises(TypeError):
        frt.fused_render_level_train(model, rays.double(), z, noise)
    with pytest.raises(ValueError):
        frt.fused_render_level_train(model, rays[:, :5], z, noise)


def test_cpu_wrapper_does_not_count_launches(params):
    before = frt.launch_train_fwd.launches, frt.launch_train_bwd.launches
    _port_render_and_grads(params, (40, 8, True, False, "float32"))
    assert (frt.launch_train_fwd.launches, frt.launch_train_bwd.launches) == before


# --------------------------------------------------------------------------
# chip_smoke.py's gradient limits: the plain backward passes, a planted fault fails
# --------------------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", [None, "gate dropped"])
def test_gradient_limits_fail_a_dropped_gate(params, compute_dtype, fault):
    """The limits ``chip_smoke.py`` holds the backward kernel to, on the CPU,
    against the reference it uses there (the explicit plain backward): the
    same backward summed in another order (chunks of 64 rays) passes them;
    without the ``[sigma + noise > 0]`` gate it fails them.  The backward
    reads the noise only in that gate, so a huge positive noise drops it."""
    n, s, white_back = 150, 12, True
    rays, z, noise, target = (torch.from_numpy(a) for a in _inputs(n, s, True))
    model = nerf_from_state(state_dict_from_jax(params))
    packed = pack_weights(model, torch_dtype(compute_dtype))
    res = frt.render_level_train_forward_plain(packed, rays, z, noise, True, white_back)
    args = (packed, rays, z, noise, res[2], res[3], res[4], *chip_smoke.cotangents(res, target), True, white_back)
    want = unpack_grads(*frt.render_level_train_backward_plain(*args))
    if fault == "gate dropped":
        args = args[:3] + (torch.full_like(noise, 1e6),) + args[4:]
    got = unpack_grads(*frt.render_level_train_backward_plain(*args, chunk=64))
    err = chip_smoke.grad_errors(got, want)
    tol = chip_smoke.K3_BWD_TOL[compute_dtype]
    if fault is None:
        assert err[0] <= tol[0] and err[1] <= tol[1], err
    else:
        assert err[0] > tol[0] and err[1] > tol[1], err


# --------------------------------------------------------------------------
# on the card: the kernels against the plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,s,white_back,use_noise", [
    (77, 12, False, True), (40, 8, True, False), (56 * 70, 16, True, True), (63 * 84, 9, False, True)])
def test_train_kernels_match_plain(cuda_device, params, n, s, white_back, use_noise, compute_dtype):
    rays, z, noise, target = (None if a is None else torch.from_numpy(a).to(cuda_device)
                              for a in _inputs(n, s, use_noise))
    model = nerf_from_state(state_dict_from_jax(params)).to(cuda_device)
    before = frt.launch_train_fwd.launches, frt.launch_train_bwd.launches
    chip_smoke.k3_check(model, rays, z, noise, target, compute_dtype, white_back, "K3")  # raises Failed
    assert (frt.launch_train_fwd.launches, frt.launch_train_bwd.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.cuda
def test_train_render_function_on_the_card(cuda_device, params):
    """The autograd Function end to end on CUDA tensors: one forward and one
    backward launch, gradients close to the plain versions'."""
    rays, z, noise, target = (torch.from_numpy(a).to(cuda_device) for a in _inputs(77, 12, True))
    model = nerf_from_state(state_dict_from_jax(params)).to(cuda_device)
    before = frt.launch_train_fwd.launches, frt.launch_train_bwd.launches
    _loss(frt.fused_render_level_train(model, rays, z, noise, True, True), target, torch).backward()
    torch.cuda.synchronize()
    assert (frt.launch_train_fwd.launches, frt.launch_train_bwd.launches) == (before[0] + 1, before[1] + 1)
    got = [p.grad.clone() for p in param_tensors(model)]
    model.zero_grad()
    _loss(frt.render_level_train_plain(model, rays, z, noise, True, True), target, torch).backward()
    err = chip_smoke.grad_errors(got, [p.grad for p in param_tensors(model)])
    assert err[0] <= chip_smoke.K3_BWD_TOL["float32"][0] and err[1] <= chip_smoke.K3_BWD_TOL["float32"][1], err


@pytest.mark.cuda
def test_half_empty_field_on_the_card(cuda_device):
    """Why ``chip_smoke.py`` trains a field that starts opaque
    (``TRAIN_SIGMA_SHIFT``): the readings on the half-empty field (sigma bias
    +0.3) of its other phases, same batch, draws and ``train_step``.  Printed
    (run with ``-s``): the loss over 4 steps on the kernel and the plain
    path, both dtypes, at Adam's 2e-4 and at 2e-5; the float32 loss along the
    first step's direction against the gradient's first-order prediction; the
    light that reaches the last sample, whose 1e10 interval makes its alpha a
    step function of sigma, and how many rays' last weight a step moves.

    Held: on either field the kernel path's losses are the plain path's
    (rtol 1e-5 in float32, 1e-4 in bfloat16, whose atomics reorder the
    sums from run to run; measured 9e-7 and up to 1.3e-5 over two runs), so the
    rise on the half-empty field is no fault of the kernels.  On the opaque
    field no ray's last weight moves, the loss falls with every step and
    follows the first-order prediction over a whole Adam step within 5%
    (measured 1.1%); on the half-empty one the last weight of more than 1000
    of the 16,384 rays moves by over 0.01 within one step (measured 2732,
    rising in proportion to the step), and the loss along the step is jagged
    at every scale read."""
    from sinnerf_tpu_torch.render.renderer import render_rays
    from sinnerf_tpu_torch.train.step import compute_losses, train_step

    rng = np.random.default_rng(0)
    batch = chip_smoke.make_train_batch(rng, cuda_device)
    draws = chip_smoke.make_draws(rng, 4 * chip_smoke.TRAIN_RAYS, cuda_device)
    rays = torch.cat([batch[k].reshape(-1, 8) for k in ("rays", "depth_ray", "rays_full", "rays_proj")])

    def losses(shift, cd, impl, lr):
        state = chip_smoke.new_train_state(cuda_device, shift, lr)
        out = []
        for _ in range(4):
            state, aux = train_step(state, batch, chip_smoke.train_config(cd, impl), 0.0, draws)
            out.append(aux["metrics"]["train/loss"].item())
        return out

    seqs = {}
    for shift in (0.3, chip_smoke.TRAIN_SIGMA_SHIFT):
        for cd in ("float32", "bfloat16"):
            for impl, lr in (("pallas", 2e-4), ("xla", 2e-4), ("pallas", 2e-5)):
                seqs[shift, cd, impl, lr] = seq = losses(shift, cd, impl, lr)
                print(f"sigma bias +{shift} {cd:8s} {impl:6s} lr {lr:.0e}: " + " -> ".join(f"{x:.6f}" for x in seq))
                assert all(np.isfinite(seq))
                if shift == chip_smoke.TRAIN_SIGMA_SHIFT:
                    assert all(b < a for a, b in zip(seq, seq[1:])), seq
            np.testing.assert_allclose(seqs[shift, cd, "pallas", 2e-4], seqs[shift, cd, "xla", 2e-4],
                                       rtol=1e-5 if cd == "float32" else 1e-4)

    for shift in (0.3, chip_smoke.TRAIN_SIGMA_SHIFT):
        cfg = chip_smoke.train_config("float32")
        state = chip_smoke.new_train_state(cuda_device, shift)
        params = [p for m in state.models.values() for p in m.parameters()]
        theta0 = [p.detach().clone() for p in params]
        state, aux = train_step(state, batch, cfg, 0.0, draws)
        loss0 = aux["metrics"]["train/loss"].item()
        delta = [p.detach() - t0 for p, t0 in zip(params, theta0)]
        slope = sum((p.grad.double() * d.double()).sum().item() for p, d in zip(params, delta))

        def at(t):
            with torch.no_grad():
                for p, t0, d in zip(params, theta0, delta):
                    p.copy_(t0 + t * d)
                total, _ = compute_losses(state.models, batch, cfg, 0.0, draws)
                last = render_rays(state.models, rays, cfg.render, *draws)["opacity_fine"][:, -1]
            return total.item(), last

        base, last0 = at(0.0)
        print(f"sigma bias +{shift}: loss {loss0:.6f} (again {base:.6f}); first-order change over the step {slope:.6f}; "
              f"mean weight of the last fine sample {last0.mean().item():.4f}")
        for t in (1e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0):
            total, last = at(t)
            moved = (last - last0).abs()
            print(f"  t={t:5.3f}: loss change {total - base:+.6f}, first order {t * slope:+.6f}, beyond it "
                  f"{total - base - t * slope:+.6f}; rays whose last weight moved by > 0.01: {(moved > 0.01).sum().item()}, "
                  f"sum |change| {moved.sum().item():.3f}")
        n_moved = (moved > 0.01).sum().item()  # over the whole step, t = 1
        if shift == chip_smoke.TRAIN_SIGMA_SHIFT:
            assert n_moved == 0 and abs(total - base - slope) < 5e-2 * abs(slope)
        else:
            assert n_moved > 1000
