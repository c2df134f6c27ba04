"""Every choice of the port's train CLI runs on the card in ``chip_smoke.py``.

``chip_smoke.py``'s ``BRANCHES`` (phase 25) and ``EARLIER_CHOICES`` (the
phases before it) must together name every value of every ``choices`` list
of ``sinnerf_tpu_torch/opt.py`` and every ``--dloss`` that
``sinnerf_tpu_torch/losses/gan.py`` accepts, so that a choice added later
without a run on the card fails here.  No card, no kernel build: the tables
are read, and their flags parsed.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from sinnerf_tpu_torch.losses.gan import DLOSSES  # noqa: E402
from sinnerf_tpu_torch.opt import _FLAG_SPEC, get_opts  # noqa: E402
from sinnerf_tpu_torch.render.renderer import RenderSettings  # noqa: E402
from sinnerf_tpu_torch.train.step import TrainConfig  # noqa: E402

CHOICE_FLAGS = ("dataset_name", "optimizer", "lr_scheduler", "loss_type", "patch_loss", "compute_dtype", "mlp_impl",
                "model")


def every_choice():
    spec = dict(_FLAG_SPEC)
    out = [(flag, value) for flag in CHOICE_FLAGS for value in spec[flag]["choices"]]
    return out + [("dloss", d) for d in DLOSSES]


def test_every_choices_list_is_listed():
    """The flags with ``choices`` are those this test walks (``--device``
    picks the card or the CPU: ``chip_smoke.py`` runs on the card)."""
    assert sorted(name for name, spec in _FLAG_SPEC if "choices" in spec) == sorted(CHOICE_FLAGS + ("device",))


@pytest.mark.parametrize("flag,value", every_choice(), ids=lambda x: str(x))
def test_choice_runs_on_the_card(flag, value):
    key = (flag, value)
    assert (key in chip_smoke.BRANCHES) != (key in chip_smoke.EARLIER_CHOICES), \
        f"--{flag} {value}: in neither or both of phase 25's BRANCHES and EARLIER_CHOICES"
    if key in chip_smoke.EARLIER_CHOICES:
        names = chip_smoke.EARLIER_CHOICES[key]
        source = "".join(inspect.getsource(getattr(chip_smoke, n)) for n in names)
        default = dict(_FLAG_SPEC)[flag]["default"]
        # the value is written in the phase, or the phase runs the train CLI with the flag's default
        assert f'"{value}"' in source or (value == default and "run_cli(" in source), (flag, value, names)


def test_phase_25_entries_are_well_formed():
    steps = {f.name for f in dataclasses.fields(TrainConfig)} | {"use_disp"}
    assert "use_disp" in {f.name for f in dataclasses.fields(RenderSettings)}
    for (flag, value), (how, what) in chip_smoke.BRANCHES.items():
        assert how in ("step", "leg", "refusal"), how
        if how == "step":
            assert set(what) <= steps and what.get(flag) == value
            continue
        # a leg's or refusal's flags parse and set the choice
        hp = get_opts(["--dataset_name", "llff_ray_patch_1image_proj"] + what)
        assert getattr(hp, flag) == value
    assert chip_smoke.BRANCHES[("spheric_poses", True)][0] == "leg"
    assert chip_smoke.BRANCHES[("use_disp", True)][0] == "step"


def test_refusals_are_the_trainers():
    """Phase 25 holds ``--loss_type l2_ssim`` and ``l2_vgg`` as refusals:
    the trainer's own check raises on them before any work."""
    from sinnerf_tpu_torch.train.loop import _check_supported

    refused = [(flag, value) for (flag, value), (how, _) in chip_smoke.BRANCHES.items() if how == "refusal"]
    assert refused == [("loss_type", "l2_ssim"), ("loss_type", "l2_vgg")]
    for flag, value in refused:
        hp = get_opts(["--num_gpus", "1", f"--{flag}", value])
        with pytest.raises(ValueError, match=f"--{flag} {value}"):
            _check_supported(hp, 1)
