"""Dataset registry (JAX ``sinnerf_tpu/data/__init__.py``, reference
``datasets/__init__.py``): the ``opt.py`` dataset names plus the eval-only
``llff``.  The training sets are Blender's (``blender.py``: rot3d and proj),
LLFF's (``llff.py``) and DTU's (``dtu.py``); each builds its scene on the
device it is given and feeds ``sampler.sample_batch``."""

from sinnerf_tpu_torch.data.blender import BlenderProj, BlenderRot3D
from sinnerf_tpu_torch.data.dtu import DTUProj
from sinnerf_tpu_torch.data.llff import LLFFEval, LLFFProj

dataset_dict = {
    "blender_ray_patch_1image_rot3d": BlenderRot3D,
    "blender_ray_patch_1image_proj": BlenderProj,
    "llff_ray_patch_1image_proj": LLFFProj,
    "dtu_proj": DTUProj,
    "llff": LLFFEval,
}
