"""The port's NeRF module, weight carrier, packing and checkpoints against the
JAX package (``sinnerf_tpu.models.nerf``, ``train/checkpoints.py``).

Tolerances: float32 1e-5 (the two sides sum the 256-wide products in
different orders); bfloat16 2e-2 (an activation that rounds to a neighbouring
bf16 value, 2^-8 relative, propagates through eight layers)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.core.encoding import positional_encoding
from sinnerf_tpu.models.nerf import export_torch_state, nerf_apply
from sinnerf_tpu.train.checkpoints import load_torch_nerf_checkpoint as jax_load_ckpt
from sinnerf_tpu_torch.core.encoding import positional_encoding as t_pe
from sinnerf_tpu_torch.models.nerf import (
    NeRF,
    jax_from_state_dict,
    nerf_from_state,
    random_params,
    state_dict_from_jax,
)
from sinnerf_tpu_torch.ops import fused_mlp
from sinnerf_tpu_torch.train.checkpoints import load_torch_nerf_checkpoint, save_torch_nerf_checkpoint

CSRC = Path(__file__).resolve().parents[1] / "sinnerf_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def params():
    p = random_params(np.random.default_rng(3))
    p["sigma"]["b"] = p["sigma"]["b"] + np.float32(0.3)
    return p


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.5, 1.5, size=(300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    return np.array(positional_encoding(jnp.asarray(xyz), 10)), np.array(positional_encoding(jnp.asarray(d), 4))


@pytest.mark.parametrize(
    "compute_dtype,sigma_only,new_act,tol",
    [
        ("float32", False, True, 1e-5),
        ("float32", False, False, 1e-5),
        ("float32", True, True, 1e-5),
        ("bfloat16", False, True, 2e-2),
    ],
)
def test_nerf_matches_nerf_apply(params, inputs, compute_dtype, sigma_only, new_act, tol):
    x_pe, d_pe = inputs
    cd = {"float32": None, "bfloat16": jnp.bfloat16}[compute_dtype]
    want = nerf_apply(params, jnp.asarray(x_pe), jnp.asarray(d_pe), sigma_only=sigma_only,
                      use_new_activation=new_act, compute_dtype=cd)
    model = nerf_from_state(state_dict_from_jax(params), use_new_activation=new_act)
    with torch.no_grad():
        got = model(torch.from_numpy(x_pe), torch.from_numpy(d_pe), sigma_only=sigma_only,
                    compute_dtype=None if cd is None else torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, dtype=np.float32), rtol=tol, atol=tol)


def test_state_dict_keys_are_the_reference_keys(params):
    assert set(NeRF().state_dict()) == set(export_torch_state(params))
    sd = state_dict_from_jax(params)
    for k, v in export_torch_state(params).items():
        assert tuple(sd[k].shape) == v.shape, k


def test_weight_carrier_round_trips(params):
    back = jax_from_state_dict(state_dict_from_jax(params))
    assert set(back) == set(params)
    for k in params:
        np.testing.assert_array_equal(back[k]["w"], params[k]["w"])
        np.testing.assert_array_equal(back[k]["b"], params[k]["b"])
    model = nerf_from_state(state_dict_from_jax(params))
    again = jax_from_state_dict(model.state_dict())
    np.testing.assert_array_equal(again["xyz_encoding_5"]["w"], params["xyz_encoding_5"]["w"])


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_mlp_plain_matches_nerf_apply(params, inputs, compute_dtype, tol):
    """The kernel's split MLP on packed weights equals the reference MLP."""
    x_pe, d_pe = inputs
    cd = {"float32": None, "bfloat16": jnp.bfloat16}[compute_dtype]
    want = np.asarray(nerf_apply(params, jnp.asarray(x_pe), jnp.asarray(d_pe), compute_dtype=cd), np.float32)
    packed = fused_mlp.pack_weights(nerf_from_state(state_dict_from_jax(params)), fused_mlp.torch_dtype(compute_dtype))
    rgb, sigma = fused_mlp.mlp_plain(packed, torch.from_numpy(x_pe), torch.from_numpy(d_pe))
    np.testing.assert_allclose(rgb.numpy(), want[:, :3], rtol=tol, atol=tol)
    np.testing.assert_allclose(sigma.numpy(), want[:, 3], rtol=tol, atol=tol)


def test_packed_layout_matches_the_cuda_header():
    """The offsets that csrc/nerf_mlp.cuh hard-codes equal the packing's."""
    text = (CSRC / "nerf_mlp.cuh").read_text()
    sizes = {"WIDTH": 256, "HALF": 128, "XYZ_PAD": 64, "DIR_PAD": 32}
    header = {}
    for name, expr in re.findall(r"constexpr int (W[0-9A-Z_]*|B[0-9A-Z_]*) = ([^;]+);", text):
        if name not in ("WIDTH", "WARPS"):
            header[name] = eval(expr, {}, {**sizes, **header})  # noqa: S307 - constants of our own header
    for name, (off, _) in fused_mlp.WEIGHT_OFFSETS.items():
        assert header[name.upper()] == off, name
    for name, (off, _) in fused_mlp.BIAS_OFFSETS.items():
        assert header[name.upper()] == off, name
    assert header["W_SIZE"] == fused_mlp.WEIGHT_SIZE


def test_checkpoints_interoperate_with_jax(tmp_path, params):
    """A .ckpt the port writes loads in the JAX package, and back."""
    states = {"coarse": state_dict_from_jax(params), "fine": state_dict_from_jax(params)}
    path = save_torch_nerf_checkpoint(str(tmp_path / "w.ckpt"), states)
    jp = jax_load_ckpt(path)
    np.testing.assert_array_equal(np.asarray(jp["fine"]["rgb"]["w"]), params["rgb"]["w"])
    back = load_torch_nerf_checkpoint(path)
    assert set(back) == {"coarse", "fine"}
    torch.testing.assert_close(back["coarse"]["dir_encoding.0.weight"], states["coarse"]["dir_encoding.0.weight"])
    # the wrapped layout of some reference checkpoints
    torch.save({"state_dict": {"model." + k: v for k, v in torch.load(path)["state_dict"].items()}},
               tmp_path / "wrapped.ckpt")
    assert set(load_torch_nerf_checkpoint(str(tmp_path / "wrapped.ckpt"))) == {"coarse", "fine"}


def test_reference_pe_port_matches_interleaved_order(inputs):
    """The port's exact PE equals the JAX one on the inputs used above."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.5, 1.5, size=(300, 3)).astype(np.float32)
    np.testing.assert_allclose(t_pe(torch.from_numpy(xyz), 10).numpy(), inputs[0], rtol=0, atol=2e-6)
