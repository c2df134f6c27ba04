"""The port's full-recipe soak (``sinnerf_tpu_torch/scripts/soak.py``) and
its status tool, on the CPU.

The recipe table is held flag for flag against the JAX package's
``scripts/soak.sh`` (its COMMON, S1, S2 and EVAL arrays read as text); the
only differences allowed are the directories and the checkpoint, the port's
``last.ckpt`` file where JAX has the orbax directory ``last``.  Then one
tiny LLFF soak (Step 1 -> Step 2 -> eval, one epoch per leg, a 32x24 rich
scene) runs twice: Step 2 starts from Step 1's ``last.ckpt``, bit for bit;
the eval leg reads Step 2's ``last.ckpt``; each leg appends its record; the
second call resumes every leg and trains nothing; ``soak_status`` merges the
two calls.  The discriminator's branch needs patches of 16 pixels or more,
so the patches are 16x16 at stride 1 (as ``tests/test_torch_step2_cli.py``).
"""

import json
import math
import os
import re
import shlex
import subprocess
import sys
from unittest import mock

import pytest
import torch

from sinnerf_tpu_torch.scripts import soak, soak_status

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
TINY = ["--device", "cpu", "--N_samples", "4", "--N_importance", "4", "--num_rays", "32", "--patch_size_x", "16",
        "--patch_size_y", "16", "--sW", "1", "--sH", "1", "--check_val_every_n_epoch", "1", "--img_wh", "32", "24"]


def _soak_sh_blocks():
    """soak.sh's text per family: the arrays each family's legs take."""
    with open(os.path.join(REPO, "scripts", "soak.sh")) as f:
        text = f.read()
    llff = text[text.index('if [ "$FAMILY" = llff ]'):text.index('elif [ "$FAMILY" = lego ]')]
    vit0_at, else_at = llff.index('if [ "$FAMILY" = llff_vit0 ]'), llff.index("\n  else\n")
    common = llff[:vit0_at]
    return text, {
        "llff_vit0": common + llff[vit0_at:else_at],
        "llff": common + llff[else_at:],
        "lego": text[text.index('elif [ "$FAMILY" = lego ]'):text.index('elif [ "$FAMILY" = dtu ]')],
        "dtu": text[text.index('elif [ "$FAMILY" = dtu ]'):text.index('echo "unknown family')],
    }


def _arrays(block):
    """The bash arrays of ``block`` as token lists, soak.sh's variables in
    the recipe table's placeholders and its orbax ``last`` as ``last.ckpt``."""
    subs = (("$ROOT", "{root}"), ("$CK", "{ck}"), ("$LOG", "{log}"), ("$E1", "{e1}"), ("$E2", "{e2}"))
    out = {}
    for name, body in re.findall(r"(\w+)=\((.*?)\)", block, flags=re.S):
        tokens = []
        for tok in shlex.split(body):
            for a, b in subs:
                tok = tok.replace(a, b)
            tokens.append(tok + ".ckpt" if tok.endswith("/last") else tok)
        out[name] = tokens
    return out


@pytest.mark.parametrize("family", sorted(soak.RECIPES))
def test_recipe_matches_soak_sh(family):
    text, blocks = _soak_sh_blocks()
    arrays = _arrays(blocks[family])
    r = soak.RECIPES[family]
    assert r["common"] == arrays["COMMON"]
    assert r["s1"] == arrays["S1"]
    assert r["s2"] == arrays.get("S2")
    assert r["eval"] == arrays.get("EVAL")
    # soak.sh's epoch defaults: lego 160 / 20, the others 2000 / 2000
    lego = re.search(r'= lego \]; then\n\s+E1=\$\{2:-(\d+)\}\n\s+E2=\$\{3:-(\d+)\}\nelse\n\s+E1=\$\{2:-(\d+)\}\n'
                     r'\s+E2=\$\{3:-(\d+)\}', text)
    e = tuple(map(int, lego.groups()))
    assert soak.DEFAULT_EPOCHS[family] == (e[:2] if family == "lego" else e[2:])
    # the legs: Step 1, then Step 2 and the eval CLI but for the control
    names = [leg for leg, _, _ in soak.legs(family, 1, 2, "R", "C", "L", ["--device", "cpu", "--num_rays", "8"])]
    assert names == (["step1"] if family == "llff_vit0" else ["step1", "step2", "eval"])


def test_legs_append_flags_and_the_eval_leg_keeps_its_own():
    extra = ["--device", "cpu", "--num_rays", "8", "--sW", "1", "--img_wh", "32", "24"]
    (_, exp1, s1), (_, exp2, s2), (_, exp_e, ev) = soak.legs("dtu", 3, 4, "/r", "/c", "/l", extra)
    assert (exp1, exp2, exp_e) == ("dtu_scan4_s8", "dtu_scan4_s8_4ft", "dtu_scan4_s8_4ft")
    assert s1[-len(extra):] == extra and s2[-len(extra):] == extra
    assert s1[s1.index("--num_epochs") + 1] == "3" and s2[s2.index("--num_epochs") + 1] == "4"
    assert s2[s2.index("--pt_model") + 1] == "/c/dtu_scan4_s8/last.ckpt"
    assert ev[-5:] == ["--device", "cpu", "--img_wh", "32", "24"]  # the eval CLI has no --num_rays or --sW
    assert ev[ev.index("--ckpt_path") + 1] == "/c/dtu_scan4_s8_4ft/last.ckpt"
    # defaults lie in the checkout, apart from the JAX soak's /tmp/soak_* and /tmp/rich_*
    assert soak.DEFAULT_WORK_DIR == os.path.join(REPO, "soak_runs")


def test_legs_flag_picks_legs_in_the_soaks_order():
    args = soak.get_args(["llff", "1600", "--legs", "step1"])
    assert (args.family, args.epochs1, args.legs) == ("llff", 1600, ("step1",))
    assert soak.get_args(["llff"]).legs == ("step1", "step2", "eval")
    picked = soak.legs("llff", 1, 2, "R", "C", "L", [], soak.get_args(["llff", "--legs", "eval,step2"]).legs)
    assert [leg for leg, _, _ in picked] == ["step2", "eval"]
    with pytest.raises(SystemExit):
        soak.get_args(["llff", "--legs", "step3"])


def test_soak_without_a_card_raises_before_writing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main(["llff", "1", "1", "--work_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "scenes")


def test_soak_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import sinnerf_tpu_torch.scripts.soak_status\n"
        "assert 'torch' not in sys.modules  # the status tool reads files only\n"
        "import sinnerf_tpu_torch.scripts.soak as s\n"
        "s.launch_counts()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib'))"
        " or k == 'sinnerf_tpu' or k.startswith('sinnerf_tpu.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.fixture(scope="module")
def tiny_soak(tmp_path_factory):
    """The tiny LLFF soak called twice, with each trainer's NeRF state at
    the start of its fit and the warm-start checkpoint's weights then
    (``chip_smoke.record_fit_starts``, as phase 24 takes them)."""
    from sinnerf_tpu_torch.train import loop
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    work = str(tmp_path_factory.mktemp("soak"))
    starts = []
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    fit = chip_smoke.record_fit_starts(starts)
    try:
        # without TensorBoard events: soak.jsonl is the record status reads
        with mock.patch.object(loop, "_make_writer", lambda log_dir: None):
            calls = [soak.main(["llff", "1", "1", "--work_dir", work, "--", *TINY]) for _ in range(2)]
    finally:
        SinNeRFTrainer.fit = fit
        torch.set_num_threads(threads)
    return dict(work=work, calls=calls, starts=starts)


def test_step2_starts_from_step1_last_ckpt(tiny_soak):
    first_step2 = [s for s in tiny_soak["starts"] if s["exp"] == "llff_room_s4_2ft"][0]
    assert first_step2["ckpt_path"] is None
    warm = first_step2["warm"]
    for level, sd in first_step2["state"].items():
        assert sd.keys() == warm[level].keys()
        assert all(torch.equal(sd[k], warm[level][k]) for k in sd)
    step1 = tiny_soak["calls"][0][0]
    assert step1["steps"] == 10 and first_step2["state"]["fine"] != {}
    assert tiny_soak["calls"][0][1]["argv"][tiny_soak["calls"][0][1]["argv"].index("--pt_model") + 1] == \
        os.path.join(tiny_soak["work"], "ck", "llff_room_s4", "last.ckpt")


def test_eval_leg_reads_step2_last_ckpt(tiny_soak):
    for call in tiny_soak["calls"]:
        ev = call[-1]
        assert ev["leg"] == "eval" and ev["images"] > 0 and math.isfinite(ev["mean_psnr"])
        assert ev["argv"][ev["argv"].index("--ckpt_path") + 1] == \
            os.path.join(tiny_soak["work"], "ck", "llff_room_s4_2ft", "last.ckpt")
        assert ev["argv"][ev["argv"].index("--device") + 1] == "cpu"
    # the same checkpoint both times: the same PSNR
    assert tiny_soak["calls"][0][-1]["mean_psnr"] == tiny_soak["calls"][1][-1]["mean_psnr"]


def test_every_leg_appends_its_record(tiny_soak):
    log = os.path.join(tiny_soak["work"], "log")
    with open(os.path.join(log, "llff_room_s4", "soak.jsonl")) as f:
        step1 = [json.loads(line) for line in f]
    with open(os.path.join(log, "llff_room_s4_2ft", "soak.jsonl")) as f:
        step2 = [json.loads(line) for line in f]
    assert [r["leg"] for r in step1] == ["step1", "step1"]
    assert [r["leg"] for r in step2] == ["step2", "eval", "step2", "eval"]
    first = step1[0]
    for key in ("val_log", "epoch_log", "lr_log", "steps_per_epoch", "step", "best_psnr", "ms_per_step", "wall_s",
                "launches_by_dtype", "card"):
        assert key in first
    assert first["lr_log"] == [[0, 2e-4]] and step2[0]["lr_log"] == [[0, 5e-5]]  # each leg's --lr at epoch 0
    assert first["steps_per_epoch"] == 10 and first["epoch_log"][0][:2] == [0, 10] and first["ms_per_step"] > 0
    assert first["card"] is None and set(first["launches_by_dtype"].values()) == {0}  # the CPU: plain versions
    assert step2[1]["ms_per_image"] > 0


def test_second_call_resumes_without_training(tiny_soak):
    (s1a, s2a, _), (s1b, s2b, _) = tiny_soak["calls"]
    for before, after in ((s1a, s1b), (s2a, s2b)):
        assert before["resumed_from"] is None
        assert after["resumed_from"] == os.path.join(tiny_soak["work"], "ck", before["exp"], "last.ckpt")
        assert after["epoch_log"] == [] and after["steps"] == 0 and after["step"] == before["step"] == 10
    resumed = [s for s in tiny_soak["starts"] if s["ckpt_path"]]
    assert [s["exp"] for s in resumed] == ["llff_room_s4", "llff_room_s4_2ft"]


def test_soak_status_merges_both_calls(tiny_soak, capsys):
    status = soak_status.main(["--log_dir", os.path.join(tiny_soak["work"], "log"), "--last", "3"])
    out = capsys.readouterr().out
    assert set(status) == {"llff_room_s4", "llff_room_s4_2ft"}
    for exp, first in (("llff_room_s4", tiny_soak["calls"][0][0]), ("llff_room_s4_2ft", tiny_soak["calls"][0][1])):
        s = status[exp]
        assert s["runs"] == 2 and s["steps"] == [10, 0] and s["step"] == 10
        assert s["val"] == {0: pytest.approx(first["val_log"][0][1])}
        assert f"{exp}: best {first['best_psnr']:.2f} dB, last {first['best_psnr']:.2f} dB | ep0=" in out
    assert len(status["llff_room_s4_2ft"]["evals"]) == 2
    assert out.count("llff_room_s4_2ft eval: mean PSNR") == 2
