"""The train path's spans (``sinnerf_tpu_torch/utils/spans.py``): a shared
no-op with no profiler running, and under ``torch.profiler`` every span of
one tiny epoch, nested as the step's phases nest, read back by the
benchmark's ``benchmark/program.py::read``."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import program
from sinnerf_tpu_torch.data import synthetic
from sinnerf_tpu_torch.utils import spans

# span -> the span it opens inside (None: at the epoch's top level)
PARENT = {
    "step": None,
    "step.losses": "step",
    "step.render": "step.losses",
    "step.vit": "step.losses",
    "step.vit.refresh": "step.vit",
    "step.disc": "step.losses",
    "step.backward": "step",
    "step.optimizer": "step",
    "sampler": None,
    "sampler.read": "sampler",
    "log.start": None,
    "log.wait": None,
    "log.write": None,
    "epoch.sync": None,
}


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("step") is spans.span("log.wait") is spans._OFF
    with spans.span("step"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("step"):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("sinnerf.step") == 1


class _Writer:
    def add_scalar(self, tag, value, step):
        pass

    def add_images(self, tag, images, step):
        np.asarray(images)

    def close(self):
        pass


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """rot3d with the ViT and D on at a tiny size: every span's code runs."""
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    tmp = tmp_path_factory.mktemp("spans")
    root = synthetic.make_blender_scene_rich(str(tmp / "lego"), (32, 32), n_train=21)
    flags = [
        "--dataset_name", "blender_ray_patch_1image_rot3d", "--root_dir", root, "--img_wh", "32", "32",
        "--N_samples", "4", "--N_importance", "4", "--num_rays", "16", "--patch_size", "16", "--sW", "1",
        "--sH", "1", "--angle", "1", "--batch_size", "1", "--num_gpus", "1", "--load_depth",
        "--depth_weight", "8", "--dis_weight", "0.01", "--vit_weight", "10", "--allow_random_pretrained",
        "--mlp_impl", "xla", "--ckpt_dir", os.path.join(tmp, "ck"), "--log_dir", os.path.join(tmp, "lg"),
        "--device", "cpu", "--prefetch_batches", "2",
    ]
    return SinNeRFTrainer(get_opts(flags))


def test_one_epoch_under_the_profiler_emits_every_span_nested(trainer):
    """Two steps, the first a log step (step 10): the epoch's end flushes
    its log, so the wait and the writes run too."""
    trainer.writer = _Writer()
    trainer.state.step = 9
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer._run_epoch(0, 2)
    marks = program.trainer_marks(program.read(prof))
    assert {m[0] for m in marks} == set(PARENT)
    assert sum(m[0] == "step" for m in marks) == 2
    assert all(sum(m[0] == n for m in marks) == 1 for n in ("log.start", "log.wait", "log.write"))
    for name, _, start, end in marks:
        enclosing = [m for m in marks if m[2] <= start and end <= m[3] and m[3] - m[2] > end - start]
        parent = min(enclosing, key=lambda m: m[3] - m[2])[0] if enclosing else None
        assert parent == PARENT[name], (name, parent)
