"""The port's train CLI on SinNeRF's two-step LLFF recipe, on the CPU at a
tiny size: Step 1 with the random-weight ViT (``--vit_weight 10
--allow_random_pretrained``), Step 2 with the PatchGAN warm-started from
Step 1 (``--dis_weight 0.01 --vit_weight 0 --pt_model <step1>/last.ckpt
--nerf_only``), a resumed Step-2 epoch, and the flags that pick the
discriminator, the ViT and the VGG or refuse them, as the JAX trainer does
(``sinnerf_tpu/train/loop.py:129-194, 247-330``).  The step itself is held
to the JAX package in ``tests/test_torch_step2.py``.
"""

import os

import numpy as np
import pytest
import torch

WH = (32, 24)
PATCH = 16  # the smallest patch the discriminator's 16 branch takes


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    from sinnerf_tpu_torch.data.synthetic import make_llff_scene

    return make_llff_scene(str(tmp_path_factory.mktemp("llff")), WH)


def _flags(root, tmp, exp, *extra):
    return [
        "--dataset_name", "llff_ray_patch_1image_proj", "--root_dir", root, "--img_wh", str(WH[0]), str(WH[1]),
        "--N_samples", "4", "--N_importance", "4", "--num_rays", "32", "--patch_size_x", str(PATCH),
        "--patch_size_y", str(PATCH), "--sW", "1", "--sH", "1", "--batch_size", "1", "--num_gpus", "1",
        "--load_depth", "--depth_weight", "8", "--proj_weight", "1", "--num_epochs", "2",
        "--check_val_every_n_epoch", "1", "--lr", "1e-3", "--decay_step", "1", "--decay_gamma", "0.5",
        "--ckpt_dir", os.path.join(tmp, "ckpts"), "--log_dir", os.path.join(tmp, "logs"), "--exp_name", exp,
        "--device", "cpu", *extra,
    ]


STEP1 = ("--vit_weight", "10", "--allow_random_pretrained", "--dis_weight", "0")


def _step2(tmp):
    return ("--dis_weight", "0.01", "--vit_weight", "0", "--pt_model", os.path.join(tmp, "ckpts", "s1", "last.ckpt"),
            "--nerf_only")


def _d_state(trainer):
    return {k: v.clone() for k, v in trainer.state.discriminator.state_dict().items()}


@pytest.fixture(scope="module")
def recipe(llff_root, tmp_path_factory):
    """Step 1 and then Step 2 through the CLI's ``main``; returns the
    directory and the trainers."""
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.__main__ import main

    tmp = str(tmp_path_factory.mktemp("recipe"))
    s1 = main(get_opts(_flags(llff_root, tmp, "s1", *STEP1)))
    s2 = main(get_opts(_flags(llff_root, tmp, "s2", *_step2(tmp))))
    return tmp, s1, s2


def test_step1_caches_the_vit_feature(recipe):
    """Step 1 runs the ViT loss; its checkpoint carries the per-item cache
    and its flags, and no discriminator."""
    tmp, s1, _ = recipe
    assert np.isfinite(s1.best_psnr) and s1.state.step == 10
    assert s1.state.discriminator is None and s1.state.opt_d is None and s1.state.vit is not None
    blob = torch.load(os.path.join(tmp, "ckpts", "s1", "last.ckpt"), weights_only=False)
    assert blob["ref_feature"].shape == (1, 384) and blob["ref_feature_valid"].tolist() == [True]
    assert torch.equal(blob["ref_feature"], s1.state.ref_feature)
    assert not any(k.startswith("D.") for k in blob["state_dict"]) and len(blob["optimizer_states"]) == 1


def test_step2_trains_the_discriminator(recipe):
    """Step 2 warm-starts the NeRFs from Step 1, trains D at a constant 0.2x
    the base lr while G's decays, and saves D under the reference's keys
    with both optimizer states."""
    tmp, _, s2 = recipe
    assert np.isfinite(s2.best_psnr) and s2.state.step == 10 and s2.state.vit is None
    assert s2.state.opt_d.param_groups[0]["lr"] == pytest.approx(0.2 * 1e-3)
    assert s2.state.opt_g.param_groups[0]["lr"] == pytest.approx(0.5 * 1e-3)
    blob = torch.load(os.path.join(tmp, "ckpts", "s2", "last.ckpt"), weights_only=False)
    d_keys = sorted(k for k in blob["state_dict"] if k.startswith("D."))
    assert d_keys == sorted(f"D.main.{s}.weight_{n}" for s in (0, 3, 6) for n in ("orig", "u", "v"))
    assert len(blob["optimizer_states"]) == 2 and blob["optimizer_states"][1]["state"]
    for k, v in _d_state(s2).items():
        assert torch.equal(blob["state_dict"]["D." + k], v), k


def test_step2_resumes_every_part_of_the_state(recipe, llff_root):
    """``--ckpt_path`` restores the NeRFs, both optimizers, the
    discriminator with its ``u``, the step and the epoch; the run goes on."""
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    tmp, _, s2 = recipe
    last = os.path.join(tmp, "ckpts", "s2", "last.ckpt")
    flags = _flags(llff_root, tmp, "s2_resumed", *_step2(tmp), "--ckpt_path", last)
    flags[flags.index("--num_epochs") + 1] = "3"
    resumed = SinNeRFTrainer(get_opts(flags))
    assert resumed.start_epoch == 2 and resumed.state.step == 10
    for k, v in _d_state(s2).items():
        assert torch.equal(resumed.state.discriminator.state_dict()[k], v), k
    for opt, saved in ((resumed.state.opt_g, s2.state.opt_g), (resumed.state.opt_d, s2.state.opt_d)):
        got, want = opt.state_dict()["state"], saved.state_dict()["state"]
        assert got.keys() == want.keys()
        for i in want:
            for name, value in want[i].items():
                assert torch.equal(torch.as_tensor(got[i][name]), torch.as_tensor(value)), (i, name)
    for level, model in resumed.state.models.items():
        for k, v in model.state_dict().items():
            assert torch.equal(v, s2.state.models[level].state_dict()[k]), (level, k)
    best = resumed.fit()
    assert np.isfinite(best) and resumed.state.step == 15 and [e[0] for e in resumed.epoch_log] == [2]
    assert not torch.equal(resumed.state.discriminator.main["0"].weight_u, s2.state.discriminator.main["0"].weight_u)


def test_step1_resume_restores_the_vit_cache(recipe, llff_root):
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    tmp, s1, _ = recipe
    flags = _flags(llff_root, tmp, "s1_resumed", *STEP1, "--ckpt_path", os.path.join(tmp, "ckpts", "s1", "last.ckpt"))
    resumed = SinNeRFTrainer(get_opts(flags))
    assert torch.equal(resumed.state.ref_feature, s1.state.ref_feature)
    assert resumed.state.ref_feature_valid.tolist() == [True]


def test_pt_model_takes_the_discriminator_unless_nerf_only(recipe, llff_root):
    """The whole-system warm start (train.py:31-33) loads D from a
    checkpoint that has one; ``--nerf_only`` keeps the fresh D."""
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    tmp, _, s2 = recipe
    pt = os.path.join(tmp, "ckpts", "s2", "last.ckpt")
    base = ("--dis_weight", "0.01", "--pt_model", pt)
    whole = SinNeRFTrainer(get_opts(_flags(llff_root, tmp, "w", *base)))
    nerf_only = SinNeRFTrainer(get_opts(_flags(llff_root, tmp, "n", *base, "--nerf_only")))
    fresh = SinNeRFTrainer(get_opts(_flags(llff_root, tmp, "f", "--dis_weight", "0.01")))
    for k, v in _d_state(s2).items():
        assert torch.equal(whole.state.discriminator.state_dict()[k], v), k
        assert torch.equal(nerf_only.state.discriminator.state_dict()[k], fresh.state.discriminator.state_dict()[k])
    ignored = SinNeRFTrainer(get_opts(_flags(llff_root, tmp, "i", *base, "--prefixes_to_ignore", "D")))
    assert torch.equal(ignored.state.discriminator.main["0"].weight_orig, fresh.state.discriminator.main["0"].weight_orig)


@pytest.mark.parametrize("extra", [("--patch_loss", "l2_vgg"), ("--loss_type", "l2_vgg"), ("--loss_type", "l2_ssim"),
                                   ("--vit_weight", "10")])
def test_refused_flags(llff_root, tmp_path, extra):
    """As in the JAX trainer: the VGG loss and the ViT without their weights
    (and without ``--allow_random_pretrained``), and the image losses on ray
    bundles."""
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    with pytest.raises(ValueError):
        SinNeRFTrainer(get_opts(_flags(llff_root, str(tmp_path), "r", *extra)))


def test_weight_files_are_loaded(llff_root, tmp_path):
    """``--vit_weights`` (DINO's layout) and ``--vgg_weights``
    (torchvision's) load the files given; under
    ``--allow_random_pretrained`` without files both are random."""
    from sinnerf_tpu_torch.models.vgg import VGG16Features
    from sinnerf_tpu_torch.models.vit import ViT
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    vit_sd = ViT(generator=torch.Generator().manual_seed(1)).state_dict()
    vgg_sd = {"features." + k: v for k, v in VGG16Features(torch.Generator().manual_seed(2)).features.state_dict().items()}
    torch.save(vit_sd, tmp_path / "dino.pth")
    torch.save(dict(vgg_sd, **{"classifier.0.weight": torch.zeros(1)}), tmp_path / "vgg.pth")
    t = SinNeRFTrainer(get_opts(_flags(llff_root, str(tmp_path), "w", "--vit_weight", "10", "--vit_weights",
                                       str(tmp_path / "dino.pth"), "--patch_loss", "l2_vgg", "--vgg_weights",
                                       str(tmp_path / "vgg.pth"))))
    for k, v in vit_sd.items():
        assert torch.equal(t.state.vit.state_dict()[k], v), k
    for k, v in vgg_sd.items():
        assert torch.equal(t.state.vgg.state_dict()[k], v), k
    r = SinNeRFTrainer(get_opts(_flags(llff_root, str(tmp_path), "r", "--vit_weight", "10", "--patch_loss", "l2_vgg",
                                       "--allow_random_pretrained")))
    assert r.state.vit is not None and r.state.vgg is not None
    assert not torch.equal(r.state.vit.cls_token, t.state.vit.cls_token)
