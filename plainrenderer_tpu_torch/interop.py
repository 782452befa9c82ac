"""Carry the JAX package's arrays over into the port's tensors.

The renderer's counterpart of carrying weights: the scene dict of
plainrenderer_tpu's scene_to_device (frame.py:1156), its FrameState and
its bake_static_luts dict (frame.py:1257) arrive here as numpy arrays (or
anything np.asarray accepts) and leave as tensors on `device`, so both
sides of a comparison start from the same scene, state and LUTs; a
sharded state (parallel/sharding.py) leaves as one band's state. This
module imports nothing of the JAX package: the caller converts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as device_mod
from .render.state import FrameState

# scene keys the port reads; anything else in the dict belongs to slices
# the port has not reached and is refused rather than dropped
SCENE_KEYS = ("corners", "corner_uvs", "corner_normals", "corner_tangents",
              "corner_bitangents", "tri_material", "tri_object",
              "material_table", "object_bb_min", "object_bb_max",
              "tri_starts", "object_build_inv")
# present only when the scene has a texture pool (frame.py:1181-1185)
TEXTURE_KEYS = ("mat_tex", "tex_info", "tex_word0", "tex_word1")
# present only when the scene has alpha-tested geometry (frame.py:1189-1191)
ALPHA_KEYS = ("alpha_masks", "tri_alpha_slot")
# present only when a scene SDF is attached (frame.py:1203-1237)
SDF_KEYS = ("sdf_volume", "sdf_albedo", "sdf_origin", "sdf_voxel_size",
            "sdf_dims", "sdf_shape", "sdf_coarse")
# present only in a dynamic scene (frame.py:363-397): this frame's and the
# previous frame's model matrices (O, 4, 4)
DYNAMIC_KEYS = ("object_transforms", "prev_object_transforms")
# present only when dynamic SDF instances are attached (frame.py:1240-1254)
DYNAMIC_SDF_KEYS = ("sdf_dyn_vols", "sdf_dyn_tokens", "sdf_dyn_pad_min",
                    "sdf_dyn_pad_max", "sdf_dyn_albedo", "sdf_dyn_obj")
LUT_KEYS = ("transmission", "multiscatter", "blue_noise")


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=dev)  # a writable copy


def scene_from_arrays(scene: dict, device="cuda") -> dict:
    """JAX scene dict (arrays) -> the port's scene tensor dict.

    A static scene SDF crosses as the port's attach_global_sdf lays it
    out: the brick pools, origin and dims as tensors, the voxel size as a
    float, the shape token's (D, H, W) as the tuple "sdf_grid", and the
    coarse tables as (sdf, albedo, (cd, ch, cw), factor). Dynamic SDF
    instances cross as attach_dynamic_sdf lays them out: a list of volume
    tensors and the window tokens' shapes as the tuple "sdf_dyn_tokens"
    of (wd, wh, ww)."""
    dev = device_mod.resolve(device)
    known = (SCENE_KEYS + TEXTURE_KEYS + ALPHA_KEYS + SDF_KEYS
             + DYNAMIC_KEYS + DYNAMIC_SDF_KEYS)
    extra = sorted(set(scene) - set(known))
    if extra:
        raise NotImplementedError(f"scene keys the port does not read: "
                                  f"{extra}")
    keys = SCENE_KEYS + tuple(k for k in TEXTURE_KEYS + ALPHA_KEYS
                              + DYNAMIC_KEYS if k in scene)
    out = {k: _tensor(scene[k], dev) for k in keys}
    for group in (SDF_KEYS, DYNAMIC_SDF_KEYS):
        present = [k for k in group if k in scene]
        if present and len(present) != len(group):
            raise ValueError(f"scene keys incomplete: {present}")
    if "sdf_volume" in scene:
        c_sdf, c_alb, c_dims, c_f = scene["sdf_coarse"]
        out.update(
            sdf_volume=_tensor(scene["sdf_volume"], dev),
            sdf_albedo=_tensor(scene["sdf_albedo"], dev),
            sdf_origin=_tensor(scene["sdf_origin"], dev),
            sdf_voxel_size=float(np.asarray(scene["sdf_voxel_size"])),
            sdf_dims=_tensor(scene["sdf_dims"], dev),
            sdf_grid=tuple(int(n) for n in np.shape(scene["sdf_shape"])[:3]),
            sdf_coarse=(_tensor(c_sdf, dev), _tensor(c_alb, dev),
                        tuple(int(n) for n in c_dims), int(c_f)))
    if "sdf_dyn_vols" in scene:
        out.update(
            sdf_dyn_vols=[_tensor(v, dev) for v in scene["sdf_dyn_vols"]],
            sdf_dyn_tokens=tuple(tuple(int(n) for n in np.shape(t)[:3])
                                 for t in scene["sdf_dyn_tokens"]),
            **{k: _tensor(scene[k], dev) for k in DYNAMIC_SDF_KEYS[2:]})
    return out


def state_from_arrays(state, device="cuda") -> FrameState:
    """JAX FrameState (a NamedTuple of arrays) -> the port's FrameState."""
    dev = device_mod.resolve(device)
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    names = [f.name for f in dataclasses.fields(FrameState)]
    if sorted(fields) != sorted(names):
        raise ValueError(f"FrameState fields differ: {sorted(fields)} vs "
                         f"{sorted(names)}")
    return FrameState(**{k: _tensor(fields[k], dev) for k in names})


def luts_from_arrays(luts: dict, device="cuda") -> dict:
    """JAX bake_static_luts dict -> the port's LUT tensor dict."""
    dev = device_mod.resolve(device)
    return {k: _tensor(luts[k], dev) for k in LUT_KEYS}


def band_state_from_arrays(state_stacked, rank: int,
                           device="cuda") -> FrameState:
    """A sharded JAX FrameState (every leaf stacked along a leading band
    axis: parallel/sharding.initial_sharded_state, or a sharded frame's
    state') -> band `rank`'s port FrameState."""
    fields = state_stacked._asdict() if hasattr(state_stacked, "_asdict") \
        else dict(state_stacked)
    return state_from_arrays({k: np.asarray(v)[rank]
                              for k, v in fields.items()}, device)
