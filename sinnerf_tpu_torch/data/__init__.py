"""Dataset registry (JAX ``sinnerf_tpu/data/__init__.py``, reference
``datasets/__init__.py``): the ``opt.py`` dataset names plus the eval-only
``llff``.  The Blender and DTU training sets come in a later slice; their
names are registered so that asking for them says so."""

from sinnerf_tpu_torch.data.llff import LLFFEval, LLFFProj


def _later(name: str):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"dataset {name!r} is ported with the Blender and DTU training sets in a later slice; "
            "the port trains on llff_ray_patch_1image_proj"
        )

    return build


dataset_dict = {
    "blender_ray_patch_1image_rot3d": _later("blender_ray_patch_1image_rot3d"),
    "blender_ray_patch_1image_proj": _later("blender_ray_patch_1image_proj"),
    "llff_ray_patch_1image_proj": LLFFProj,
    "dtu_proj": _later("dtu_proj"),
    "llff": LLFFEval,
}
