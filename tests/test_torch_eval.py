"""The port's renderer and eval CLI against the JAX package, end to end on
the CPU, plus the port's import and device rules.

Tolerances: renders 1e-4 (float32; the coarse weights differ by ~1e-6, which
moves the resampled depths by as much); the eval CLIs' PNGs within one
8-bit level and their mean PSNR within 0.01 dB."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import eval as jax_eval  # noqa: E402
from sinnerf_tpu.data.synthetic import make_llff_scene as jax_make_llff_scene  # noqa: E402
from sinnerf_tpu.models.nerf import export_torch_state  # noqa: E402
from sinnerf_tpu.render import renderer as jax_renderer  # noqa: E402
from sinnerf_tpu_torch import eval as port_eval  # noqa: E402
from sinnerf_tpu_torch.data.depth_io import read_pfm  # noqa: E402
from sinnerf_tpu_torch.data.synthetic import make_llff_scene  # noqa: E402
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax  # noqa: E402
from sinnerf_tpu_torch.render import renderer as port_renderer  # noqa: E402
from sinnerf_tpu_torch.train.checkpoints import save_torch_nerf_checkpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(seed):
    p = random_params(np.random.default_rng(seed))
    p["sigma"]["b"] = p["sigma"]["b"] + np.float32(0.3)  # a partly opaque field
    return p


@pytest.fixture(scope="module")
def level_params():
    return {"coarse": _params(40), "fine": _params(41)}


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(40)
    n = 150
    o = rng.normal(scale=0.3, size=(n, 3))
    d = rng.normal(scale=0.3, size=(n, 3)) + [0.0, 0.0, -1.0]
    nf = np.broadcast_to([2.0, 6.0], (n, 2))
    return np.concatenate([o, d, nf], 1).astype(np.float32)


def _models(level_params):
    return {k: nerf_from_state(state_dict_from_jax(v)) for k, v in level_params.items()}


@pytest.mark.parametrize("n_importance", [8, 0])
def test_render_chunked_matches_jax_pallas(level_params, rays, n_importance):
    """Port kernel path (plain versions on the CPU) vs JAX's fused kernels."""
    settings = dict(n_samples=8, n_importance=n_importance)
    want = jax_renderer.render_chunked(
        jax.tree_util.tree_map(jnp.asarray, level_params), jnp.asarray(rays),
        jax_renderer.RenderSettings(mlp_impl="pallas", **settings), tile=64,
    )
    got = port_renderer.render_chunked(
        _models(level_params), torch.from_numpy(rays), port_renderer.RenderSettings(mlp_impl="pallas", **settings), 64
    )
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)


def test_stochastic_plain_render_matches_jax_xla(level_params, rays):
    """The plain path with perturb, sigma noise and pdf draws passed in, vs
    JAX's xla path on the draws its key gives (renderer.py:234)."""
    s, k, n = 8, 8, rays.shape[0]
    key = jax.random.key(3)
    jset = jax_renderer.RenderSettings(n_samples=s, n_importance=k, perturb=1.0, noise_std=0.5, mlp_impl="xla")
    want = jax.jit(jax_renderer.render_rays, static_argnums=3)(
        jax.tree_util.tree_map(jnp.asarray, level_params), jnp.asarray(rays), key, jset)

    @jax.jit
    def draws(key):
        k_perturb, k_noise_c, k_pdf, k_noise_f = jax.random.split(key, 4)
        return (jax.random.uniform(k_perturb, (n, s)), jax.random.normal(k_noise_c, (n, s)),
                jax.random.uniform(k_pdf, (n, k)), jax.random.normal(k_noise_f, (n, s + k)))

    perturb_u, noise_coarse, pdf_u, noise_fine = (torch.from_numpy(np.array(a)) for a in draws(key))
    with torch.no_grad():  # render_rays records gradients when they are on
        got = port_renderer.render_rays(
            _models(level_params), torch.from_numpy(rays),
            port_renderer.RenderSettings(n_samples=s, n_importance=k, perturb=1.0, noise_std=0.5, mlp_impl="xla"),
            perturb_u=perturb_u, noise_coarse=noise_coarse, pdf_u=pdf_u, noise_fine=noise_fine,
        )
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-4, err_msg=name)


def test_kernel_path_refuses_stochastic_renders(level_params, rays):
    """The kernel path used to refuse every stochastic render; with the
    train render kernel it renders them.  What it still refuses is a
    gradient for the rays: only the models' parameters get one."""
    models = _models(level_params)
    r = torch.from_numpy(rays).requires_grad_()
    settings = port_renderer.RenderSettings(n_samples=8, n_importance=8)
    assert settings.mlp_impl == "pallas" and settings.perturb > 0 and settings.noise_std > 0
    out = port_renderer.render_rays(models, r, settings, generator=torch.Generator().manual_seed(0))
    assert out["rgb_fine"].shape == (rays.shape[0], 3) and out["opacity_fine"].shape == (rays.shape[0], 16)
    assert all(bool(v.isfinite().all()) for v in out.values())
    (out["rgb_fine"].sum() + out["depth_coarse"].sum()).backward()
    assert r.grad is None
    for level in ("coarse", "fine"):
        assert all(p.grad is not None and bool(p.grad.isfinite().all()) for p in models[level].parameters())


def test_eval_cli_matches_jax_eval(tmp_path, monkeypatch, level_params):
    """The slice as a whole: the two eval CLIs on one scene and one .ckpt."""
    root = make_llff_scene(str(tmp_path / "llff"), (32, 24))
    jax_root = jax_make_llff_scene(str(tmp_path / "llff_jax"), (32, 24))
    for f in ("poses_bounds.npy",):  # the two generators write the same scene
        np.testing.assert_array_equal(np.load(os.path.join(root, f)), np.load(os.path.join(jax_root, f)))
    states = {k: {kk: torch.from_numpy(np.array(v)) for kk, v in export_torch_state(p).items()}
              for k, p in level_params.items()}
    ckpt = save_torch_nerf_checkpoint(str(tmp_path / "ckpts" / "w.ckpt"), states)
    flags = ["--root_dir", root, "--dataset_name", "llff", "--split", "val", "--img_wh", "32", "24",
             "--N_samples", "8", "--N_importance", "8", "--ckpt_path", ckpt, "--timestamp", "t", "--save_depth"]
    monkeypatch.chdir(tmp_path)
    psnr_jax = jax_eval.main(jax_eval.get_opts(flags + ["--scene_name", "jax"]))
    psnr_port = port_eval.main(port_eval.get_opts(flags + ["--scene_name", "port", "--device", "cpu"]))
    assert abs(psnr_port - psnr_jax) <= 0.01
    from PIL import Image

    jax_png = np.asarray(Image.open(tmp_path / "results" / "llff" / "jax" / "t" / "000.png")).astype(int)
    port_png = np.asarray(Image.open(tmp_path / "results" / "llff" / "port" / "t" / "000.png")).astype(int)
    assert jax_png.shape == port_png.shape == (24, 32, 3)
    assert np.abs(jax_png - port_png).max() <= 1
    assert jax_png.std() > 0, "the render must not be flat"
    assert (tmp_path / "results" / "llff" / "port" / "t" / "port.gif").exists()
    depth_jax, _ = read_pfm(str(tmp_path / "results" / "llff" / "jax" / "t" / "depth_000.pfm"))
    depth_port, _ = read_pfm(str(tmp_path / "results" / "llff" / "port" / "t" / "depth_000.pfm"))
    np.testing.assert_allclose(depth_port, depth_jax, rtol=1e-4, atol=1e-4)


def test_eval_cli_without_device_flag_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_eval.get_opts(["--root_dir", str(tmp_path), "--dataset_name", "llff", "--ckpt_path", "x.ckpt"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_eval.main(args)


def test_eval_cli_rejects_what_is_not_ported(tmp_path, monkeypatch, level_params):
    """Orbax directories are refused, and on ``cuda`` rendering over more
    cards than are visible; the DTU set, a later slice once, renders
    (tests/test_torch_blender_dtu_cli.py holds it to JAX's eval.py), and so
    does ``--num_gpus 2`` with ``--device cpu``: two gloo ranks, the same
    mean PSNR, rank 0's files alone."""
    flags = ["--root_dir", str(tmp_path), "--ckpt_path", str(tmp_path), "--dataset_name", "llff", "--num_gpus", "2"]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="does not fall back"):
            port_eval.main(port_eval.get_opts(flags))
    with pytest.raises(ValueError, match="orbax"):
        port_eval.load_models(str(tmp_path), torch.device("cpu"))
    from sinnerf_tpu_torch.data.synthetic import make_dtu_scene

    root = make_dtu_scene(str(tmp_path / "dtu"), (32, 32))
    ckpt = save_torch_nerf_checkpoint(str(tmp_path / "w.ckpt"),
                                      {k: state_dict_from_jax(v) for k, v in level_params.items()})
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # one thread for each of two ranks
    try:
        psnr = {n: port_eval.main(port_eval.get_opts([
            "--root_dir", root, "--ckpt_path", ckpt, "--dataset_name", "dtu_proj", "--split", "val", "--img_wh",
            "32", "32", "--N_samples", "4", "--N_importance", "4", "--timestamp", f"t{n}", "--device", "cpu",
            "--num_gpus", str(n)])) for n in (1, 2)}
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(psnr[1]) and abs(psnr[2] - psnr[1]) < 0.01
    for n in (1, 2):
        assert len(os.listdir(tmp_path / "results" / "dtu_proj" / "test" / f"t{n}")) == 4 + 1  # 4 PNGs, the GIF


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys\n"
        "import sinnerf_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(sinnerf_tpu_torch.__path__, 'sinnerf_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib'))"
        " or k == 'sinnerf_tpu' or k.startswith('sinnerf_tpu.'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 20 and 'sinnerf_tpu_torch.parallel.ddp' in mods, mods\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_port(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line without a card
    (as here), and in a directory that holds it and nothing of the port."""
    import shutil

    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
