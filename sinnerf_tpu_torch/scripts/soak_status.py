"""Print the val PSNR history of running and finished soaks: the
counterpart of the JAX package's ``scripts/soak_status.py``.

    python -m sinnerf_tpu_torch.scripts.soak_status [--log_dir soak_runs/log] [--last N]

Per experiment under ``--log_dir``: the last N val PSNRs, the best, the last
and the step counts, merged over every run of the leg (resumed ones
included) from the ``soak.jsonl`` records that ``soak`` appends after each
run, and from TensorBoard event files where a TensorBoard package imports;
an eval leg's mean PSNR on its own line.  It reads files only and never
touches the card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

from sinnerf_tpu_torch.scripts.soak import DEFAULT_WORK_DIR


def read_records(exp_dir: str) -> List[dict]:
    path = os.path.join(exp_dir, "soak.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def event_val_psnr(exp_dir: str) -> Dict[int, float]:
    """val/psnr per epoch from every TensorBoard event file under
    ``exp_dir`` (each restart opens a new one), or {} where no TensorBoard
    package imports."""
    files = sorted(glob.glob(os.path.join(exp_dir, "**", "events*"), recursive=True))
    if not files:
        return {}
    try:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    except ImportError:
        return {}
    out = {}
    for f in files:
        ea = EventAccumulator(f)
        ea.Reload()
        if "val/psnr" in ea.Tags()["scalars"]:
            out.update({int(e.step): float(e.value) for e in ea.Scalars("val/psnr")})
    return out


def collect(log_dir: str) -> Dict[str, dict]:
    """Per experiment: ``val`` (epoch -> val PSNR over all its runs),
    ``runs`` (train runs recorded), ``step`` (the last run's global step),
    ``steps`` (steps trained in each run), ``ms_per_step`` (each run's) and
    ``evals`` (the eval leg's records)."""
    out = {}
    for exp_dir in sorted(d for d in glob.glob(os.path.join(log_dir, "*")) if os.path.isdir(d)):
        records = read_records(exp_dir)
        train = [r for r in records if r["leg"] != "eval"]
        val = event_val_psnr(exp_dir)
        for r in sorted(train, key=lambda r: r["time"]):
            val.update({int(e): float(p) for e, p in r["val_log"]})
        if not records and not val:
            continue
        out[os.path.basename(exp_dir)] = dict(
            val=dict(sorted(val.items())), runs=len(train), step=train[-1]["step"] if train else None,
            steps=[r["steps"] for r in train], ms_per_step=[r["ms_per_step"] for r in train],
            evals=[r for r in records if r["leg"] == "eval"])
    return out


def lines(status: Dict[str, dict], last: int) -> List[str]:
    out = []
    for name, s in status.items():
        runs = f"step {s['step']} over {s['runs']} runs ({' + '.join(map(str, s['steps']))} steps trained)"
        if s["val"]:
            epochs = list(s["val"])
            recent = ", ".join(f"ep{e}={s['val'][e]:.2f}" for e in epochs[-last:])
            out.append(f"{name}: best {max(s['val'].values()):.2f} dB, last {s['val'][epochs[-1]]:.2f} dB | "
                       f"{recent} | {runs}")
        elif s["runs"]:
            out.append(f"{name}: no val/psnr yet | {runs}")
        for r in s["evals"]:
            ms = "n/a" if r["ms_per_image"] is None else f"{r['ms_per_image']:.1f}"
            psnr = "none" if r["mean_psnr"] is None else f"{r['mean_psnr']:.2f} dB"
            out.append(f"{name} eval: mean PSNR {psnr} over {r['images']} images, {ms} ms per image")
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description="val PSNR history of the soaks under --log_dir")
    ap.add_argument("--log_dir", default=os.path.join(DEFAULT_WORK_DIR, "log"))
    ap.add_argument("--last", type=int, default=4)
    args = ap.parse_args(argv)
    status = collect(args.log_dir)
    if not status:
        print(f"no experiments under {args.log_dir}")
    for line in lines(status, args.last):
        print(line)
    return status


if __name__ == "__main__":
    main()
