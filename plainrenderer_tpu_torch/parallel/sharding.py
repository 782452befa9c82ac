"""Split-frame band rendering over torch.distributed
(plainrenderer_tpu/parallel/sharding.py).

The screen is split into horizontal bands, one per rank, and every rank
runs the whole frame on its band (render_frame's band mode):

  - geometry and main-view binning run on every rank against the whole
    scene, each band through its asymmetric sub-frustum (the band's rows
    of the frame's projection), so its pixels are the single-device
    frame's;
  - each rank bins and rasterizes one band of the shadow atlas's bins
    and the bands are gathered, so the group renders every cascade once;
  - the exposure histogram is summed over the bands and the cascade fit
    takes the frame's depth range (min / max), so every band exposes and
    fits alike;
  - the stencil passes (the GI chain, the fog's upsamples, TAA, bloom)
    exchange 1-48 halo rows with the neighbouring bands (halo.py);
  - the temporal state stays with its band: each rank keeps its band's
    histories, and no state crosses ranks.

The JAX package runs this under shard_map on a device mesh; here each
band is a process of a torch.distributed group (comm.py), launched by
comm.launch, and these functions keep the JAX package's names:
make_mesh returns the rank's BandGroup, initial_sharded_state the band's
state, sharded_frame_fn the per-rank frame function and the band
settings, assemble_image the bands put together.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod
from ..config import RenderSettings
from ..ops.raster import TILE_H
from ..render import frame as frame_mod
from ..render.state import initial_state
from .comm import BandGroup


def make_mesh(device="cuda") -> BandGroup:
    """This rank's BandGroup over the default process group (joined by
    comm.launch or by the caller), rendering on `device` (cuda means the
    rank's current card)."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return BandGroup(dev)


def band_settings(settings: RenderSettings, n_devices: int) -> RenderSettings:
    """Per-band settings: the same width, 1/N of the height rounded down
    to whole 16-row tiles (at least one); N bands of it make the frame."""
    band_h = settings.height // n_devices
    band_h = max(TILE_H, band_h // TILE_H * TILE_H)
    return dataclasses.replace(settings, height=band_h)


def band_camera(cam: dict, rank: int, n_devices: int) -> dict:
    """cam with band `rank`'s sub-frustum (sharding.py:74-80): the band
    covers frame NDC y in [rank, rank + 1) / N * 2 - 1, mapped onto
    [-1, 1] by y' = N * y - centre * N; both leaves 0-d f32 tensors (made
    with fills, in the JAX package's f32 operation order)."""
    n = np.float32(n_devices)
    centre = (np.float32(rank) + np.float32(0.5)) / n * np.float32(2.0) \
        - np.float32(1.0)
    dev = cam["position"].device
    cam = dict(cam)
    cam["ndc_y_scale"] = torch.full((), float(n), dtype=torch.float32,
                                    device=dev)
    cam["ndc_y_offset"] = torch.full((), float(-centre * n),
                                     dtype=torch.float32, device=dev)
    return cam


def sharded_frame_fn(settings: RenderSettings, n_devices: int):
    """(run, band settings): run(group, state, scene, cam, luts, dt,
    timer=None) renders this rank's band of one frame and returns (the
    band's image (band_h, W, 3), its state'), every input on the rank's
    device."""
    bset = band_settings(settings, n_devices)
    full_h = bset.height * n_devices

    def run(group, state, scene, cam, luts, dt, timer=None):
        if group.size != n_devices:
            raise ValueError(f"a {group.size}-rank group for {n_devices} "
                             "bands")
        return frame_mod.render_frame(
            state, scene, band_camera(cam, group.rank, n_devices), luts, dt,
            bset, device=group.device, timer=timer, group=group,
            full_height=full_h)

    return run, bset


def initial_sharded_state(settings: RenderSettings, n_devices: int,
                          device="cuda"):
    """This rank's initial band state (every band starts alike)."""
    bset = band_settings(settings, n_devices)
    return initial_state(bset.width, bset.height, device=device)


def assemble_image(image, group: BandGroup | None = None):
    """The bands put together into the frame: with a group, this rank's
    (band_h, W, 3) band gathered from every rank (a tensor on every
    rank); without, stacked bands (N, band_h, W, 3) reshaped into
    (N * band_h, W, 3) (a numpy array, as the JAX package's)."""
    if group is not None:
        return group.all_gather(image, 0)
    img = np.asarray(image)
    return img.reshape(-1, *img.shape[2:])


def to_device(tree, device):
    """tree (tensors in dicts, lists and tuples, other leaves kept) with
    every tensor moved to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return tree


def render_bands(group: BandGroup, settings: RenderSettings, scene: dict,
                 cam: dict, luts: dict, n_frames: int,
                 delta_time: float = 1.0 / 60.0, state=None) -> dict:
    """A rank entry for comm.launch: n_frames frames of this rank's band
    of `settings`' frame, the inputs (on any device) moved to the rank's
    device first, state the band's (initial_sharded_state when None; a
    list holds one state per rank). Returns, on the CPU, the last
    frame's band "image", the band's "state" and every frame's
    "debug_counters"."""
    dev = group.device
    scene, cam, luts = (to_device(x, dev) for x in (scene, cam, luts))
    run, _ = sharded_frame_fn(settings, group.size)
    if isinstance(state, (list, tuple)):
        state = state[group.rank]
    if state is None:
        state = initial_sharded_state(settings, group.size, device=dev)
    state = to_device(state, dev)
    counters = []
    for _ in range(n_frames):
        image, state = run(group, state, scene, cam, luts, delta_time)
        counters.append(state.debug_counters)
    return {"image": image.cpu(), "state": to_device(state, "cpu"),
            "debug_counters": torch.stack(counters).cpu(),
            "transport": group.transport, "stats": dict(group.stats)}
