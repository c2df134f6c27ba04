"""The port's data parallelism (``parallel/ddp.py``) against the JAX
package's mesh on the CPU: four gloo ranks of ``train_step`` against JAX's
``train_step`` on ``make_mesh(4)`` with ``replicate`` and ``shard_batch``,
and four ranks of ``render_chunked_sharded`` against JAX's; plus the
launcher's rules.

The ranks run in processes of their own (``ddp.launch``), the port's code
only (``tests/ddp_workers.py``); this process writes their inputs to a file
and runs the JAX side on 4 of the 8 virtual CPU devices that
``tests/conftest.py`` sets up, while they run.  A Step-1 case (the LLFF
losses, Adam) and a Step-2 case (the ViT and the PatchGAN, hinge, SGD),
each two steps on a global batch of 4 items, on ``tests/test_torch_step2.py``'s tiny
NeRF, ViT and discriminator with JAX's draws: each rank takes its items of
every per-ray and per-item draw (the four ray bundles are concatenated item
by item, so a rank's rays are four slices), and every rank the ``()``
coins.

Tolerances.  The mean over ranks of each rank's loss, and the metrics the
ranks reduce to the global batch's, against JAX's: rtol 1e-4 (atol 1e-5), as
the one-process steps.  Parameters after each step in the bands of the
one-process tests of the same optimizer.  Step 1, Adam with weight decay
(``tests/test_torch_train_step.py::test_three_steps_match_optax``): the
leaves whose gradient passes no ReLU mask within 1e-4 (first step) and 5e-3
(second) of the distance moved in relative L2, the trunk's elements off by
more than 1e-5 fewer than 6%.  Step 2, SGD with momentum
(``tests/test_torch_step2.py::test_two_train_steps_match_jax``): per leaf
the largest difference over the largest distance moved, the mask-free
leaves and the discriminator's within 1e-4 (first step) and 5e-3 (second),
the trunk's within 3e-2.  Step 2 takes SGD as that file does: Adam's first
steps are ``lr * sign(g)``, so a discriminator weight whose gradient lies
within rounding of zero moves by up to 2 lr (measured: a conv's relative L2
1.4e-3 after two steps for the one-process port as for the ranks, against
JAX).  D's ``u`` and each rank's ViT cache rows rtol 1e-5 (atol 1e-6), as
``tests/test_torch_step2.py``.  Every rank's parameters, ``u`` and
optimizer state are bit-identical to rank 0's.  The sharded render: 1e-4 against
JAX's (``tests/test_torch_eval.py``'s band), bit-equal to the port's own
one-process ``render_chunked``.
"""

import argparse
import ast
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_workers
from sinnerf_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from sinnerf_tpu.render import renderer as jax_renderer
from sinnerf_tpu.train import optimizers as jax_optimizers
from sinnerf_tpu.train import step as jax_step
from sinnerf_tpu_torch.models import discriminator as port_disc
from sinnerf_tpu_torch.models import vit as port_vit
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.parallel import ddp
from sinnerf_tpu_torch.render import renderer as port_renderer
from sinnerf_tpu_torch.train import step as port_step
from step2_draws import jax_step2_draws
from test_torch_step2 import (  # noqa: F401  (weights is a fixture)
    DEPTH, FIELDS, JAX_FIELDS, N_RAND, NDF, PS, VIT_BLOCKS, WIDTH, _mask_free, _render_draws, _settings, make_batch,
    weights)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, ITEMS, STEPS = 4, 4, 2
STEP1_FIELDS = dict(dataset_name="llff_ray_patch_1image_proj", depth_weight=8.0, proj_weight=1.0,
                    depth_smooth_weight=0.5)
# name: (Step 2?, TrainConfig fields, optimizer flags as the one-process tests take them)
CASES = {"step1": (False, STEP1_FIELDS, dict(optimizer="adam", lr=2e-4, momentum=0.9, weight_decay=1e-2)),
         "step2": (True, dict(FIELDS, dloss="hinge"), dict(optimizer="sgd", lr=1e-2, momentum=0.9, weight_decay=0.0))}
RENDER_RAYS, RENDER_TILE = 300, 32  # 300 is no multiple of 32 * 4
RENDER_SETTINGS = dict(n_samples=8, n_importance=8)


def _rank_draws(render_draws, step2_draws, rank):
    """Rank ``rank``'s share of a step's draws: its items' rays of each
    bundle, its items of the per-item draws, the () coins as they are."""
    b = ITEMS // WORLD
    rows = ddp.bundle_rows((N_RAND, PS * PS, PS * PS, N_RAND), rank, WORLD, ITEMS)
    return ddp.shard_draws(render_draws, rows), ddp.shard_draws(step2_draws, slice(rank * b, (rank + 1) * b))


def _key(case, step):
    return jax.random.key(70 + 10 * list(CASES).index(case) + step)


def _render_inputs():
    rng = np.random.default_rng(90)
    params = {"coarse": random_params(rng), "fine": random_params(rng)}
    for p in params.values():
        p["sigma"]["b"] = p["sigma"]["b"] + np.float32(0.3)  # a partly opaque field
    o = rng.normal(scale=0.3, size=(RENDER_RAYS, 3))
    d = rng.normal(scale=0.3, size=(RENDER_RAYS, 3)) + [0.0, 0.0, -1.0]
    nf = np.broadcast_to([2.0, 6.0], (RENDER_RAYS, 2))
    return params, np.concatenate([o, d, nf], 1).astype(np.float32)


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """The port's four ranks (in the background) and the JAX mesh's steps
    and render on the same inputs: {'port': each rank's result, 'jax':
    {case: [(metrics, state) per step]}, 'jax_render', 'render_inputs'}."""
    nerf, d_params, sn, vit = weights
    batch = make_batch(ITEMS)
    cases = {}
    for name, (step2, fields, hp) in CASES.items():
        keys = [_key(name, s) for s in range(STEPS)]
        global_draws = [_render_draws(k, ITEMS * (2 * N_RAND + 2 * PS * PS)) for k in keys]
        s2 = [jax_step2_draws(k, ITEMS, (3, PS, PS)) if step2 else port_step.Step2Draws() for k in keys]
        shares = [[_rank_draws(g, d, r) for g, d in zip(global_draws, s2)] for r in range(WORLD)]
        cases[name] = dict(
            step2=step2, fields=fields, hp=hp, global_render_draws=global_draws, global_step2_draws=s2,
            render_draws=[[g for g, _ in rank] for rank in shares], step2_draws=[[d for _, d in rank] for rank in shares])
    render_params, rays = _render_inputs()
    inputs = dict(
        nerf={lvl: state_dict_from_jax(p) for lvl, p in nerf.items()}, depth=DEPTH, width=WIDTH, ndf=NDF,
        disc=port_disc.discriminator_state_from_jax(d_params, sn, -1, NDF),
        vit=port_vit.vit_state_from_jax(vit), vit_blocks=VIT_BLOCKS,
        render=dict(n_samples=4, n_importance=4, perturb=1.0, noise_std=1.0, white_back=True, mlp_impl="xla"),
        batch=batch, cases=cases,
        render_case=dict(rays=rays, tile=RENDER_TILE, settings=dict(mlp_impl="pallas", **RENDER_SETTINGS),
                         nerf={lvl: state_dict_from_jax(p) for lvl, p in render_params.items()}),
    )
    path = str(tmp_path_factory.mktemp("ddp") / "inputs.pt")
    torch.save(inputs, path)
    port = {}

    def ranks():
        try:
            port["ranks"] = ddp.launch(ddp_workers.steps_and_render, WORLD, "cpu", path)
        except BaseException as e:  # raised again below, in the test's thread
            port["error"] = e

    threads = torch.get_num_threads()
    torch.set_num_threads(WORLD)  # launch gives each rank its share: one thread
    worker = threading.Thread(target=ranks)
    worker.start()

    mesh = make_mesh(WORLD)
    jbatch = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    jax_runs = {}
    for name, (step2, fields, hp) in CASES.items():
        hp = argparse.Namespace(**hp)
        opt_g, opt_d = jax_optimizers.get_optimizer(hp), jax_optimizers.get_optimizer(hp, rate=0.2)
        jcfg = jax_step.TrainConfig(render=_settings(jax_renderer), **(dict(JAX_FIELDS, dloss="hinge") if step2
                                                                      else fields))
        extras = dict(d_params=d_params, sn_state=sn, opt_d=opt_d.init(d_params), vit_params=vit,
                      ref_feature=jnp.zeros((ITEMS, 384)), ref_feature_valid=jnp.zeros((ITEMS,), bool)) if step2 \
            else dict(d_params=None, sn_state=None, opt_d=None, vit_params=None, ref_feature=None)
        jstate = replicate(jax_step.TrainState(params=nerf, opt_g=opt_g.init(nerf), vgg_params=None,
                                               step=jnp.zeros((), jnp.int32), **extras), mesh)
        jax_runs[name] = []
        for s in range(STEPS):
            # replicated again: the step returns the ViT cache sharded by
            # item, and another input sharding would compile the step again
            jstate, jout = jax_step.train_step(replicate(jstate, mesh), jbatch, _key(name, s), jnp.asarray(0.0),
                                               jcfg, opt_g, opt_d if step2 else None)
            jax_runs[name].append(({k: np.asarray(v) for k, v in jout["metrics"].items()},
                                   jax.tree_util.tree_map(np.asarray, jstate)))
    jparams = replicate(jax.tree_util.tree_map(jnp.asarray, render_params), mesh)
    jax_render = jax_renderer.render_chunked_sharded(
        jparams, jnp.asarray(rays), jax_renderer.RenderSettings(mlp_impl="pallas", **RENDER_SETTINGS), mesh,
        tile=RENDER_TILE)
    worker.join()
    torch.set_num_threads(threads)
    if "error" in port:
        raise port["error"]
    return dict(port=port["ranks"], jax=jax_runs, jax_render={k: np.asarray(v) for k, v in jax_render.items()},
                render_inputs=(render_params, rays))


def _errors(got, want, start, step2):
    """A leaf's distance from ``want`` in its case's measure: SGD, the largest
    difference over the largest distance moved from ``start``; Adam, the
    relative L2 over the distance moved and the share of elements off by
    more than 1e-5."""
    if step2:
        return (np.abs(got - want).max() / np.abs(want - start).max(),)
    return np.linalg.norm(got - want) / np.linalg.norm(want - start), np.mean(np.abs(got - want) > 1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_train_step_matches_jax_mesh(runs, weights, case):
    """Two steps: the global loss, and every leaf of both models after each
    step, D's ``u`` and each rank's ViT cache rows.  A leaf lies in its
    band, or where the one-process port on the same global batch lies
    outside it too (on this batch Step 2's ``coarse.xyz_encoding_final``,
    2.2e-4 after the first step, in one process as on the ranks), no further
    from JAX than the one-process port plus 1e-5."""
    nerf, d_params, _, _ = weights
    step2 = CASES[case][0]
    start = {f"{lvl}.{k}": v.numpy() for lvl, p in nerf.items() for k, v in state_dict_from_jax(p).items()}
    for s, (want_metrics, jstate) in enumerate(runs["jax"][case]):
        ranks = [r[case][s] for r in runs["port"]]
        one = runs["port"][0][f"{case}_one"][s]
        loss = np.mean([r["metrics"]["train/loss"].item() for r in ranks])
        np.testing.assert_allclose(loss, want_metrics["train/loss"], rtol=1e-4)
        want = {f"{lvl}.{k}": v.numpy() for lvl, p in jstate.params.items() for k, v in state_dict_from_jax(p).items()}
        tight = 1e-4 if s == 0 else 5e-3
        leaves = [(name, p.numpy(), one["params"][name].numpy(), want[name], start[name],
                   _mask_free(name.split(".", 1)[1])) for name, p in ranks[0]["params"].items()]
        if step2:
            leaves += [(f"D{i}", a.numpy(), b.numpy(), w["w"], w0["w"], True) for i, (a, b, w, w0) in enumerate(
                zip(ranks[0]["d_params"], one["d_params"], jstate.d_params["convs"], d_params["convs"]))]
        for name, got, got_one, w, w0, mask_free in leaves:
            if step2:
                band = (tight if mask_free else 3e-2,)
            else:
                band = (tight, 1.0) if mask_free else (np.inf, 6e-2)
            err, err_one = _errors(got, w, w0, step2), _errors(got_one, w, w0, step2)
            assert all(e < b or e <= e1 + 1e-5 for e, e1, b in zip(err, err_one, band)), (s, name, err, err_one, band)
        if step2:
            for got, w in zip(ranks[0]["d_u"], jstate.sn_state["convs"]):
                np.testing.assert_allclose(got.numpy(), w["u"], rtol=1e-5, atol=1e-6)
            rows = np.concatenate([r["ref_feature"].numpy() for r in ranks])
            np.testing.assert_allclose(rows, jstate.ref_feature, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_train_step_is_the_one_process_step(runs, weights, case):
    """The ranks' step is the one-process step on the global batch up to
    rounding (the ranks sum over their items, then the all-reduce over the
    ranks): the loss rtol 1e-6; every leaf's largest difference below 1e-3
    of its largest distance moved and its relative L2 below 1e-4 of the
    distance (measured up to 6.5e-5 and 2.0e-5), but under Adam the
    trunk's, whose elements off by more than 1e-5 are fewer than 1% (Adam's
    first step is ``lr * sign(g)``: an element whose gradient lies within
    rounding of zero can turn by 2 lr; seen: one of 2,016)."""
    nerf, _, _, _ = weights
    step2 = CASES[case][0]
    start = {f"{lvl}.{k}": v for lvl, p in nerf.items() for k, v in state_dict_from_jax(p).items()}
    for s, one in enumerate(runs["port"][0][f"{case}_one"]):
        got = runs["port"][0][case][s]
        loss = np.mean([r[case][s]["metrics"]["train/loss"].item() for r in runs["port"]])
        np.testing.assert_allclose(loss, one["metrics"]["train/loss"].item(), rtol=1e-6)
        for name, b in one["params"].items():
            diff, moved = got["params"][name] - b, b - start[name]
            if step2 or _mask_free(name.split(".", 1)[1]):
                assert diff.abs().max() < 1e-3 * moved.abs().max(), (s, name)
                assert diff.norm() < 1e-4 * moved.norm(), (s, name)
            else:
                assert (diff.abs() > 1e-5).float().mean() < 1e-2, (s, name)


def test_ranks_reduce_the_global_metrics(runs):
    """``ddp.reduce_metrics`` of the ranks' step metrics gives JAX's global
    batch's: means, ``depth_min``/``depth_max`` and the PSNR of the mean
    squared error (each rank's are those of its own items)."""
    for case in CASES:
        for s, (want, _) in enumerate(runs["jax"][case]):
            reduced = runs["port"][0][case][s]["reduced"]
            assert set(reduced) == set(want)
            for tag, v in want.items():
                np.testing.assert_allclose(reduced[tag].numpy(), v, rtol=1e-4, atol=1e-5, err_msg=(case, s, tag))
            per_rank = [r[case][s]["metrics"]["train/psnr"].item() for r in runs["port"]]
            assert len(set(per_rank)) == WORLD  # the ranks saw items of their own


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_hold_bit_identical_state(runs, case):
    """After every step each rank's parameters, D's ``u`` and both Adam
    optimizers' moments equal rank 0's bit for bit: the all-reduce leaves
    the same gradients everywhere."""
    for s in range(STEPS):
        first = runs["port"][0][case][s]
        for other in runs["port"][1:]:
            o = other[case][s]
            assert all(torch.equal(o["params"][k], v) for k, v in first["params"].items()), (case, s)
            keys = ("opt_g", "d_params", "d_u", "opt_d") if CASES[case][0] else ("opt_g",)
            for key in keys:
                flat_a = [t for x in first[key] for t in (x if isinstance(x, tuple) else (x,))]
                flat_b = [t for x in o[key] for t in (x if isinstance(x, tuple) else (x,))]
                assert all(torch.equal(a, b) for a, b in zip(flat_a, flat_b)), (case, s, key)


def test_sharded_render_matches_jax_and_one_process(runs):
    """Four ranks' ``render_chunked_sharded`` at a ray count that is no
    multiple of ``tile * 4``: every rank holds the whole image, equal to
    JAX's sharded render (interpret-mode kernels) and bit-equal to the
    port's one-process ``render_chunked``."""
    params, rays = runs["render_inputs"]
    models = {k: nerf_from_state(state_dict_from_jax(v)) for k, v in params.items()}
    settings = port_renderer.RenderSettings(mlp_impl="pallas", **RENDER_SETTINGS)
    one = port_renderer.render_chunked(models, torch.from_numpy(rays), settings, RENDER_TILE)
    want = runs["jax_render"]
    for r in runs["port"]:
        got = r["render"]
        assert set(got) == set(want) == set(one)
        for k in want:
            assert got[k].shape[0] == RENDER_RAYS
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, atol=1e-4, err_msg=k)
            assert torch.equal(got[k], one[k]), k


def test_all_gather_rows_is_in_rank_order(runs):
    for r in runs["port"]:
        assert r["gathered"].tolist() == [v for rank in range(WORLD) for v in (rank, 10 * rank)]


def test_shard_rows_and_rays():
    batch = {"a": torch.arange(8).reshape(4, 2), "b": torch.arange(4)}
    assert ddp.shard_rows(batch, 1, 2)["a"].tolist() == [[4, 5], [6, 7]]
    assert ddp.shard_rows(batch, 3, 4)["b"].tolist() == [3]
    with pytest.raises(ValueError):
        ddp.shard_rows(batch, 0, 3)
    rays = torch.arange(10 * 8, dtype=torch.float32).reshape(10, 8)
    slabs = [ddp.shard_rays(rays, r, 3, 2) for r in range(3)]
    assert all(n == 10 and s.shape == (4, 8) for s, n in slabs)  # 10 rays padded to 12 = 2 * 3 * 2
    assert torch.equal(torch.cat([s for s, _ in slabs])[:10], rays)
    assert bool((slabs[2][0][2:] == 1.0).all())


def test_world_for_refuses_cuda_with_too_few_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert ddp.world_for(2, "cuda") == 2
    with pytest.raises(RuntimeError, match="does not fall back"):
        ddp.world_for(4, "cuda")
    assert ddp.world_for(4, "cpu") == 4
    with pytest.raises(ValueError):
        ddp.world_for(0, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ddp.world_for(1, "cuda")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert ddp.world_for(3, "cpu") == 3
    with pytest.raises(ValueError, match="WORLD_SIZE=3"):
        ddp.world_for(2, "cpu")


def test_launch_on_the_cpu_never_imports_the_kernel_build():
    """``launch`` on the CPU runs its ranks without importing ``ops/_build``
    (on cards it builds every kernel before it spawns)."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from sinnerf_tpu_torch.parallel import ddp\n"
        "import ddp_workers\n"
        "out = ddp.launch(ddp_workers.rank_of, 2, 'cpu')\n"
        "assert out == [(0, 2, 0, 2), (1, 2, 1, 2)], out\n"
        "assert 'sinnerf_tpu_torch.ops._build' not in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def _launch_calls(path):
    """(wrapper, line, whether under ``with torch.cuda.device(...)``) of each
    call in ``path`` that passes a CUDA stream to a ctypes entry point."""
    tree = ast.parse(open(path).read())
    out = []

    def visit(node, fn, guarded):
        if isinstance(node, ast.FunctionDef):
            fn = node.name
        if isinstance(node, ast.With) and any("cuda.device" in ast.unparse(item.context_expr) for item in node.items):
            guarded = True
        if isinstance(node, ast.Call) and any("cuda_stream" in ast.unparse(a) or ast.unparse(a) == "stream"
                                              for a in node.args):
            out.append((fn, node.lineno, guarded))
        for child in ast.iter_child_nodes(node):
            visit(child, fn, guarded)

    visit(tree, None, False)
    return out


@pytest.mark.parametrize("wrapper", ["fused_render.py", "fused_render_train.py", "fused_mlp.py",
                                     "fused_sample_pdf.py"])
def test_every_kernel_launch_runs_on_its_tensors_card(wrapper):
    """Each wrapper launches its kernels under ``torch.cuda.device(<the
    tensors' device>)``: the ctypes entry points launch on the CUDA
    runtime's current card, the stream they are given is the tensors'."""
    calls = _launch_calls(os.path.join(REPO, "sinnerf_tpu_torch", "ops", wrapper))
    assert calls, wrapper
    assert all(guarded for _, _, guarded in calls), [c for c in calls if not c[2]]


@pytest.mark.parametrize("dloss", ["hinge", "relavistic"])
def test_batch_coins_agree_across_ranks(dloss):
    """The () draws of a step's discriminator calls come from a generator
    every rank seeds alike, so every rank draws the same; the per-item
    DiffAugment draws are left to each rank's own generator."""
    a, b = (port_step.batch_coins(dloss, torch.Generator().manual_seed(11), torch.device("cpu")) for _ in range(2))
    calls = ["d_fake_g", "d_real", "d_fake"] + (["d_real_g"] if dloss == "relavistic" else [])
    for name in calls:
        for x, y in ((getattr(a, name).coin, getattr(b, name).coin), (getattr(a, name).aug.skip, getattr(b, name).aug.skip)):
            assert x.shape == () and x.dtype == torch.bool and torch.equal(x, y), name
        assert getattr(a, name).aug.brightness is None and getattr(a, name).aug.cutout_h is None
    relavistic = dloss == "relavistic"
    assert (a.real_g_coin is not None) == relavistic and (a.real_g_aug.skip is not None) == relavistic
    assert a.refresh is None and (a.d_real_g.coin is not None) == relavistic
