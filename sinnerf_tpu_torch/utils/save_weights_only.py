"""Strip a training checkpoint of the port down to its model weights.

Counterpart of ``sinnerf_tpu/utils/save_weights_only.py`` with ``--torch``
(reference ``utils/save_weights_only.py``): the train CLI's ``.ckpt`` also
carries the optimizer states, the ViT cache, the top-k ranking and the
flags; the stripped file holds ``{'state_dict': {nerf_coarse.*,
nerf_fine.*, D.*}, 'epoch'}``, the keys and layouts that the JAX package's
``export_torch_checkpoint`` (``train/checkpoints.py:250``) writes for the
same weights.  It loads in the port's eval CLI, as ``--pt_model``, and in
the reference's ``eval.py`` / ``load_ckpt``.

    python -m sinnerf_tpu_torch.utils.save_weights_only <train.ckpt> <out.ckpt>
"""

from __future__ import annotations

import argparse

import torch

from sinnerf_tpu_torch.train.checkpoints import read_checkpoint, write_checkpoint

WEIGHT_PREFIXES = ("nerf_coarse.", "nerf_fine.", "D.")


def save_weights_only(ckpt_path: str, out_path: str) -> str:
    """Write ``ckpt_path``'s NeRF and discriminator weights to
    ``out_path``.  Every tensor is copied: a state dict's tensors may alias
    live buffers."""
    blob = read_checkpoint(ckpt_path)
    state = blob.get("state_dict", blob)
    weights = {k: torch.as_tensor(v).detach().cpu().clone() for k, v in state.items()
               if k.startswith(WEIGHT_PREFIXES)}
    if not any(k.startswith(WEIGHT_PREFIXES[:2]) for k in weights):
        raise KeyError(f"no NeRF weights found in {ckpt_path}")
    return write_checkpoint(out_path, {"state_dict": weights, "epoch": int(blob.get("epoch") or 0)})


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ckpt_path", help="a training .ckpt of the port's train CLI")
    ap.add_argument("out_path", help="the weights-only .ckpt to write")
    args = ap.parse_args(argv)
    return save_weights_only(args.ckpt_path, args.out_path)


if __name__ == "__main__":
    print(main())
