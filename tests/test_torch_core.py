"""The port's core functions (``sinnerf_tpu_torch.core``) against their JAX
counterparts in ``sinnerf_tpu.core``, on the same numpy inputs and draws.

Float32 throughout; tolerance 1e-6 (1e-5 for the recurrence PE, whose
double-angle error is of that order, DESIGN §5)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.core import activations as j_act
from sinnerf_tpu.core import encoding as j_enc
from sinnerf_tpu.core import rays as j_rays
from sinnerf_tpu.core import sampling as j_samp
from sinnerf_tpu_torch.core import activations as t_act
from sinnerf_tpu_torch.core import composite as t_comp
from sinnerf_tpu_torch.core import encoding as t_enc
from sinnerf_tpu_torch.core import rays as t_rays
from sinnerf_tpu_torch.core import sampling as t_samp

# the package re-exports a function named composite; take the module
j_comp = importlib.import_module("sinnerf_tpu.core.composite")

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("fn", ["widened_sigmoid", "shifted_softplus"])
def test_activation_matches_jax(fn):
    x = np.random.default_rng(0).normal(scale=4.0, size=(257,)).astype(np.float32)
    _close(getattr(t_act, fn)(_t(x)), getattr(j_act, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("n_freqs", [4, 10])
def test_positional_encoding_matches_jax(n_freqs):
    x = np.random.default_rng(1).uniform(-2, 2, size=(64, 3)).astype(np.float32)
    # sin/cos of up to 2^9 |x|: the two libraries' sin may differ by an ulp
    _close(t_enc.positional_encoding(_t(x), n_freqs), j_enc.positional_encoding(jnp.asarray(x), n_freqs),
           rtol=0, atol=2e-6)


@pytest.mark.parametrize("n_freqs", [4, 10])
def test_recurrence_pe_matches_jax_blocked(n_freqs):
    """The interleaved recurrence PE equals the JAX blocked recurrence PE
    (``positional_encoding_blocked_t``) reordered to the reference order."""
    x = np.random.default_rng(2).uniform(-2, 2, size=(64, 3)).astype(np.float32)
    blocked = np.asarray(j_enc.positional_encoding_blocked_t(jnp.asarray(x.T), n_freqs)).T
    inv = np.argsort(j_enc.blocked_perm(3, n_freqs))
    _close(t_enc.positional_encoding_recurrence(_t(x), n_freqs), blocked[:, inv], rtol=0, atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True])
def test_ray_directions_match_jax(sparse):
    h, w, focal = 24, 32, np.float64(38.4)
    n_h, n_w = (5, 7) if sparse else (-1, -1)
    _close(t_rays.get_ray_directions(h, w, focal, n_h, n_w), j_rays.get_ray_directions(h, w, focal, n_h, n_w))
    ii, jj = t_rays.pixel_grid(h, w, n_h, n_w)
    ji, jjj = j_rays.pixel_grid(h, w, n_h, n_w)
    _close(ii, ji)
    _close(jj, jjj)


_C2W = np.array([[0.8, -0.2, 0.56, 1.1], [0.3, 0.9, -0.3, -0.4], [-0.5, 0.4, 0.76, 4.0]], np.float32)
_DIRS = np.random.default_rng(5).normal(size=(6, 7, 3)).astype(np.float32)
RAY_HELPER_CASES = {
    "get_rays": lambda m, a: m.get_rays(a(_DIRS), a(_C2W)),
    "make_ray_bundle": lambda m, a: m.make_ray_bundle(a(_DIRS), a(_C2W), 2.0, 6.0),
    "get_ndc_rays": lambda m, a: m.get_ndc_rays(24, 32, 38.4, 1.0, *m.get_rays(a(_DIRS), a(_C2W))),
}


@pytest.mark.parametrize("name", sorted(RAY_HELPER_CASES))
def test_ray_helpers_match_jax(name):
    got = RAY_HELPER_CASES[name](t_rays, _t)
    want = RAY_HELPER_CASES[name](j_rays, jnp.asarray)
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("use_disp,perturb", [(False, 0.0), (True, 0.0), (False, 1.0), (True, 0.5)])
def test_stratified_z_vals_match_jax(use_disp, perturb):
    rng = np.random.default_rng(3)
    near = rng.uniform(1, 2, size=(40, 1)).astype(np.float32)
    far = near + rng.uniform(2, 4, size=(40, 1)).astype(np.float32)
    key = jax.random.key(5)
    want = j_samp.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 16, use_disp, perturb, key)
    # the same uniforms JAX draws inside (sampling.py:50)
    u = np.asarray(jax.random.uniform(key, (40, 16), dtype=jnp.float32))
    got = t_samp.stratified_z_vals(_t(near), _t(far), 16, use_disp, perturb, u=_t(u))
    _close(got, want)


@pytest.mark.parametrize("det,sorted_u", [(True, False), (False, False), (False, True)])
def test_sample_pdf_matches_jax(det, sorted_u):
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(2, 6, size=(50, 17)), axis=1).astype(np.float32)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    # uniform weights, as the JAX package's own test draws them: where a bin's
    # pdf is below the 1e-5 guard an ulp of CDF moves a sample by a bin, and
    # jnp.cumsum and torch.cumsum sum in different orders
    w = rng.uniform(size=(50, 15)).astype(np.float32)
    key = jax.random.key(9)
    want = j_samp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 24, det=det, key=key, sorted_u=sorted_u)
    u = np.asarray(jax.random.uniform(key, (50, 24), dtype=jnp.float32))
    got = t_samp.sample_pdf(_t(bins), _t(w), 24, det=det, u=None if det else _t(u), sorted_u=sorted_u)
    # JAX's fused CDF may differ from the cumsum by an ulp (ROADMAP queue 3)
    _close(got, want, rtol=1e-5, atol=1e-6)


def _composite_inputs():
    rng = np.random.default_rng(6)
    n, s = 30, 12
    z = np.sort(rng.uniform(2, 6, size=(n, s)), axis=1).astype(np.float32)
    sig = rng.normal(scale=2.0, size=(n, s)).astype(np.float32)
    rgb = rng.uniform(size=(n, s, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return z, sig, rgb, d


@pytest.mark.parametrize("noise_std", [0.0, 0.7])
def test_compute_weights_matches_jax(noise_std):
    z, sig, _, d = _composite_inputs()
    key = jax.random.key(2)
    want = j_comp.compute_weights(jnp.asarray(sig), jnp.asarray(z), jnp.asarray(d), noise_std, key)
    noise = None
    if noise_std > 0:  # the same draw as composite.py:43
        noise = _t(noise_std * np.asarray(jax.random.normal(key, sig.shape, dtype=jnp.float32)))
    _close(t_comp.compute_weights(_t(sig), _t(z), _t(d), noise), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("white_back", [False, True])
def test_composite_matches_jax(white_back):
    z, sig, rgb, d = _composite_inputs()
    want = j_comp.composite(jnp.asarray(rgb), jnp.asarray(sig), jnp.asarray(z), jnp.asarray(d),
                            white_back=white_back)
    got = t_comp.composite(_t(rgb), _t(sig), _t(z), _t(d), white_back=white_back)
    for g, wnt in zip(got, want):
        _close(g, wnt, rtol=1e-5, atol=1e-6)
