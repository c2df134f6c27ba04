"""Reference-format checkpoints: ``.ckpt`` files holding ``{'state_dict':
{nerf_coarse.*, nerf_fine.*, D.*}}``.

Counterpart of ``sinnerf_tpu/train/checkpoints.py``: ``load_torch_nerf_checkpoint``
(:186-230) with ``prefixes_to_ignore`` and, for the whole-system load, the
discriminator under the reference's ``D.main.<slot>.weight_orig / weight_u /
weight_v`` keys (``load_torch_discriminator``), ``export_torch_checkpoint``
(:250), and ``TopKCheckpointManager`` (:132, reference ``train.py:34-35``:
top-2 on val/psnr plus ``last``).  A training checkpoint is a
reference-format file that also carries what a resume needs: the optimizer
states ``[opt_g, opt_d]``, the ViT cache and its flags, the epoch, the step,
the top-k ranking and the flags.  The JAX package's orbax checkpoint
directories are not read by the port.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable

import numpy as np
import torch

from sinnerf_tpu_torch.models.discriminator import Discriminator, import_torch_discriminator_state
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


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The whole blob of a ``.ckpt``.  It is unpickled in full
    (``weights_only=False``), as the reference's own loader does, so read
    only checkpoints you trust."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the port reads reference-format .ckpt files only, not orbax "
            "checkpoint directories; write one with the JAX package's `save_weights_only --torch`"
        )
    return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_nerf_checkpoint(path: str, prefixes_to_ignore: Iterable[str] = ()) -> Dict[str, Dict[str, torch.Tensor]]:
    """The coarse/fine NeRF weights of a reference (pytorch-lightning)
    checkpoint as ``{'coarse': state_dict, 'fine': state_dict}`` with the
    ``nerf_coarse.``/``nerf_fine.`` prefixes stripped.  Keys may also sit
    under a ``model.`` or ``module.`` wrapper; keys starting with one of
    ``prefixes_to_ignore`` are dropped first (reference
    ``extract_model_state_dict``, ``utils/__init__.py:60-83``)."""
    blob = read_checkpoint(path)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    prefixes = tuple(prefixes_to_ignore or ())
    if prefixes:
        state = {k: v for k, v in state.items() if not k.startswith(prefixes)}
    for wrapper in ("", "model.", "module."):
        out = {}
        for name, prefix in LEVELS:
            own = _nerf_state(state, wrapper + prefix)
            if own:
                out[name] = own
        if out:
            return out
    raise KeyError(f"no NeRF weights found in {path}")


def load_torch_discriminator(path: str, model: Discriminator, prefixes_to_ignore: Iterable[str] = ()) -> bool:
    """Load the discriminator of a reference checkpoint (keys ``D.*``, also
    under a ``model.`` or ``module.`` wrapper) into ``model``; False, and
    ``model`` untouched, when the checkpoint has none (JAX
    ``load_torch_nerf_checkpoint(nerf_only=False)`` :231-244)."""
    blob = read_checkpoint(path)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    prefixes = tuple(prefixes_to_ignore or ())
    if prefixes:
        state = {k: v for k, v in state.items() if not k.startswith(prefixes)}
    for prefix in ("D.", "model.D.", "module.D."):
        if any(k.startswith(prefix + "main.") for k in state):
            import_torch_discriminator_state(model, state, prefix=prefix)
            return True
    return False


def nerf_state_dict(states: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """``{'coarse': state_dict, 'fine': state_dict}`` -> the reference's
    prefixed, CPU ``state_dict``."""
    sd = {}
    for name, prefix in LEVELS:
        for key, value in states.get(name, {}).items():
            sd[prefix + key] = torch.as_tensor(value).detach().cpu().contiguous()
    if not sd:
        raise KeyError("no 'coarse'/'fine' NeRF state to write")
    return sd


def write_checkpoint(path: str, blob: Dict[str, Any]) -> str:
    """Write a blob atomically (a crash leaves the previous file whole)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def save_torch_nerf_checkpoint(path: str, states: Dict[str, Dict[str, torch.Tensor]]) -> str:
    """Write ``{'coarse': state_dict, 'fine': state_dict}`` as a
    reference-format ``.ckpt``."""
    return write_checkpoint(path, {"state_dict": nerf_state_dict(states), "epoch": 0})


class TopKCheckpointManager:
    """The best ``top_k`` checkpoints by val/psnr plus a rolling ``last``
    (``ModelCheckpoint(monitor='val/psnr', mode='max', save_top_k=2,
    save_last=True)``).  Files are ``<ckpt_dir>/epoch_<e>_psnr_<p>.ckpt``
    and ``<ckpt_dir>/last.ckpt``.  The (score, name) ranking travels in every
    saved blob under ``ckpt_best`` and comes back on resume; a NaN score
    never enters it."""

    def __init__(self, ckpt_dir: str, top_k: int = 2, best=None):
        self.ckpt_dir = ckpt_dir
        self.top_k = top_k
        os.makedirs(ckpt_dir, exist_ok=True)
        self.best = [(float(p), str(n)) for p, n in (best or [])
                     if os.path.isfile(os.path.join(ckpt_dir, str(n)))]
        self.best.sort(key=lambda t: -t[0])

    def save(self, blob: Dict[str, Any], epoch: int, val_psnr: float) -> None:
        name = f"epoch_{epoch}_psnr_{val_psnr:.2f}.ckpt"
        keep = bool(np.isfinite(val_psnr)) and (len(self.best) < self.top_k or val_psnr > self.best[-1][0])
        dropped = []
        if keep:
            self.best.append((float(val_psnr), name))
            self.best.sort(key=lambda t: -t[0])
            while len(self.best) > self.top_k:
                dropped.append(self.best.pop()[1])
        blob = dict(blob, ckpt_best=[[p, n] for p, n in self.best])
        write_checkpoint(os.path.join(self.ckpt_dir, "last.ckpt"), blob)
        if keep:
            write_checkpoint(os.path.join(self.ckpt_dir, name), blob)
        for drop in dropped:
            path = os.path.join(self.ckpt_dir, drop)
            if os.path.isfile(path):
                os.remove(path)
