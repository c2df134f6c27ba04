"""Reference-format NeRF checkpoints: ``{'state_dict': {nerf_coarse.*,
nerf_fine.*}}`` ``.ckpt`` files.

Counterpart of ``sinnerf_tpu/train/checkpoints.py``: the ``nerf_only`` path
of ``load_torch_nerf_checkpoint`` (:186-230) and the NeRF part of
``export_torch_checkpoint`` (:250).  The JAX package's orbax checkpoint
directories are not read by the port.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from sinnerf_tpu_torch.models.nerf import TORCH_KEY_MAP

LEVELS = (("coarse", "nerf_coarse."), ("fine", "nerf_fine."))


def _nerf_state(state: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    own = {}
    for torch_prefix in TORCH_KEY_MAP.values():
        for suffix in (".weight", ".bias"):
            key = f"{prefix}{torch_prefix}{suffix}"
            if key in state:
                own[f"{torch_prefix}{suffix}"] = torch.as_tensor(state[key]).float()
    return own


def load_torch_nerf_checkpoint(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """Load the coarse/fine NeRF weights of a reference (pytorch-lightning)
    checkpoint as ``{'coarse': state_dict, 'fine': state_dict}`` with the
    ``nerf_coarse.``/``nerf_fine.`` prefixes stripped.  Keys may also sit
    under a ``model.`` or ``module.`` wrapper.  The file is unpickled in full
    (``weights_only=False``), as the reference's own loader does, so load
    only checkpoints you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    for wrapper in ("", "model.", "module."):
        out = {}
        for name, prefix in LEVELS:
            own = _nerf_state(state, wrapper + prefix)
            if own:
                out[name] = own
        if out:
            return out
    raise KeyError(f"no NeRF weights found in {path}")


def save_torch_nerf_checkpoint(path: str, states: Dict[str, Dict[str, torch.Tensor]]) -> str:
    """Write ``{'coarse': state_dict, 'fine': state_dict}`` as a
    reference-format ``.ckpt``."""
    sd = {}
    for name, prefix in LEVELS:
        for key, value in states.get(name, {}).items():
            sd[prefix + key] = torch.as_tensor(value).detach().cpu().contiguous()
    if not sd:
        raise KeyError("no 'coarse'/'fine' NeRF state to write")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    torch.save({"state_dict": sd, "epoch": 0}, path)
    return path
