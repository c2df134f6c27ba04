"""The readings that a cell's correctness limits are set from, on several
seeds in one process:

    python3 -m benchmark.control --workload llff_room.step1 --seeds 11,12,13

For each seed it sets the cell up as a run does and, in place of the
window, reads the checked steps (train) or renders the checked images
(eval) through the program.  It then prints one JSON line per seed with the
numbers compared for: ``program`` (the lower reading), ``control`` (the
reference in the precision one step below the configuration's, the
traffic's ``control_precision``, put in the program's place) and each fault
the cell can have: ``half_batch`` (half of each random-ray bundle left out,
the means over the rest), ``unchanged`` (a step that returns its state
unchanged: the program's first moments and a zero change) and, for eval,
``altered`` (the first 256 pixels of one checked image raised by 1/255).
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import spec
from benchmark.run import _environment, _leg
from benchmark.train_leg import run_in_tmp


def detail(cell: spec.Cell, prog, ref) -> dict:
    """Where the program's gaps lie: the three worst leaves of each leaf
    number (train), the share of pixels over each of a few gaps and the
    99th percentile (eval)."""
    from benchmark import judge

    if cell.traffic["leg"] == "train":
        leaves = judge.counted_leaves(ref["grads"])
        out = {}
        for key in ("grads", "change"):
            gaps = judge.leaf_gaps(prog[key], ref[key], leaves)
            out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        out["losses"] = [prog["losses"], ref["losses"]]
        return out
    gap = torch.cat([(p["rgb_fine"].double() - r["rgb_fine"].double()).abs().amax(-1) for p, r in zip(prog, ref)])
    out = {f"share_over_{t:g}": float((gap > t).double().mean()) for t in (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)}
    out["p99"] = float(torch.quantile(gap.float(), 0.99))
    out["rgb_mean"] = float(torch.cat([r["rgb_fine"] for r in ref]).double().mean())
    return out


def readings(cell: spec.Cell, seed: int, device: str = "cuda", extra_flags=()) -> dict:
    def body(work):
        leg = _leg(cell)(cell, seed, device, work, extra_flags)
        t0 = time.perf_counter()
        if cell.traffic["leg"] == "eval":
            from benchmark.trace import Spans

            for i in leg.check:
                leg._image(i, Spans(False))
        else:
            leg.warm_up()
        prog = leg.free()
        ref = leg.reference()
        out = {"seed": seed, "program": leg.numbers(prog, ref)}
        control = leg.reference(precision=cell.traffic["control_precision"])
        out["control"] = leg.numbers(control, ref)
        if cell.traffic["leg"] == "train":
            out["half_batch"] = leg.numbers(leg.reference(halve=True), ref)
            out["unchanged"] = leg.numbers({**prog, "change": {k: 0 * v for k, v in prog["change"].items()}}, ref)
        else:
            altered = [dict(p) for p in prog]
            altered[0]["rgb_fine"] = altered[0]["rgb_fine"].clone().reshape(-1, 3)
            altered[0]["rgb_fine"][:256] += 1.0 / 255.0
            out["altered"] = leg.numbers(altered, ref)
        out["detail"] = detail(cell, prog, ref)
        out["seconds"] = time.perf_counter() - t0
        return out

    return run_in_tmp(body)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = parser.parse_args(argv)
    _environment(spec.ROOT)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": cell.name, **readings(cell, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
