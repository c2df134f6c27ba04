"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests:
the program on its plain path (``--mlp_impl xla``) on the CPU, the scene
and the render a few pixels and samples wide, the flags appended last
(argparse keeps a flag's last value)."""

from __future__ import annotations

import copy

from benchmark import spec

SCENE_WH = {"llff_room": (32, 24), "lego": (32, 32)}
TRAIN = {
    "llff_room": ["--patch_size_x", "16", "--patch_size_y", "16"],
    "lego": ["--patch_size", "16", "--angle", "1"],
}
COMMON = ["--N_samples", "4", "--N_importance", "4", "--mlp_impl", "xla"]


def cell(name: str):
    """(cell, extra flags): the cell ``name`` of BENCHMARK.json at the
    tiny size."""
    c = spec.load_cell(name)
    c.config = copy.deepcopy(c.config)
    cfg = c.config["name"]
    w, h = SCENE_WH[cfg]
    c.config["scene"]["img_wh"] = [w, h]
    extra = ["--img_wh", str(w), str(h), *COMMON]
    if c.traffic["leg"] == "train":
        extra += ["--num_rays", "32", "--sW", "1", "--sH", "1", *TRAIN[cfg]]
    else:
        extra += ["--chunk", "256"]
    return c, extra
