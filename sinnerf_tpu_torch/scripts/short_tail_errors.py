"""How K4-fwd in bfloat16 rounds against its plain version on short tails:
the mean absolute error of the Hopper kernel (``launch_mlp_fwd``) and of the
earlier wmma kernel (``launch_mlp_fwd_wmma``) at few points, over many draws,
for the sigma-only pass and the full one.

    python -m sinnerf_tpu_torch.scripts.short_tail_errors [--points 333] [--draws 200]

``chip_smoke.py`` holds each short tail's mean to ``K4_FWD_TOL`` draw by
draw; over few points one bf16 activation that rounds to its neighbour apart
from the plain version decides the mean.  Prints the card (``nvidia-smi``
name and power limit), per kernel and pass the mean, median and largest of
the draws' means and how many pass the limit, how many draws the two kernels
give the same outputs bit for bit, and one JSON line.  The points are
``chip_smoke.py``'s (normal, scale 2), the weights its seed-4 model.  Needs a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=333)
    ap.add_argument("--draws", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import torch

    import chip_smoke as cs
    from sinnerf_tpu_torch.ops import fused_mlp as fm

    if not torch.cuda.is_available():
        print("short_tail_errors: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(cs.card_line())
    packed = fm.pack_weights(cs.make_model(4, device), torch.bfloat16)
    limit = cs.K4_FWD_TOL["bfloat16"][1]
    means = {f"{k}_{p}": [] for k in ("hopper", "wmma") for p in ("sigma_only", "full")}
    same = 0
    for draw in range(args.draws):
        rng = np.random.default_rng(1000 + draw)
        xyz = torch.tensor(rng.normal(scale=2.0, size=(args.points, 3)), dtype=torch.float32, device=device)
        dirs = torch.tensor(rng.normal(size=(args.points, 3)), dtype=torch.float32, device=device)
        outs = {}
        for sigma_only, p in ((True, "sigma_only"), (False, "full")):
            ref = fm.nerf_mlp_forward_plain(packed, xyz, dirs, True, sigma_only)
            d = None if sigma_only else dirs
            for k, launch in (("hopper", fm.launch_mlp_fwd), ("wmma", fm.launch_mlp_fwd_wmma)):
                outs[k, p] = launch(packed, xyz, d, True, sigma_only)
                means[f"{k}_{p}"].append((outs[k, p] - ref).abs().mean().item())
        same += all(torch.equal(outs["hopper", p], outs["wmma", p]) for p in ("sigma_only", "full"))
    out = {"points": args.points, "draws": args.draws, "limit": limit, "bit_equal_draws": same}
    for name, v in means.items():
        v = np.array(v)
        out[name] = dict(mean=float(v.mean()), median=float(np.median(v)), max=float(v.max()),
                         over_limit=int((v > limit).sum()))
        print(f"{name:18s} mean {v.mean():.3e}, median {np.median(v):.3e}, largest {v.max():.3e}; "
              f"{(v > limit).sum()} of {args.draws} draws over {limit:.0e}")
    print(f"the two kernels equal bit for bit on {same} of {args.draws} draws")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
