"""PFM depth-map I/O (host-side).

The port's own copy of ``sinnerf_tpu/data/depth_io.py`` (reference
``datasets/depth_utils.py``: endianness from the scale sign, rows stored
bottom-up).
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np


def read_pfm(filename: str) -> Tuple[np.ndarray, float]:
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")

        dim_line = f.readline().decode("utf-8")
        match = re.match(r"^(\d+)\s(\d+)\s*$", dim_line)
        if not match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, match.groups())

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.ascontiguousarray(np.flipud(data.reshape(shape))), scale


def save_pfm(filename: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("image must be HxWx3, HxWx1 or HxW")

    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)
