"""The port's slice as a whole against the repository's golden frame.

tools/make_golden.py:33-58 renders 3 frames of the small textured atrium
with the default RenderSettings() except GI at 16 steps, 512^2 shadow
maps and exposure_adaption_speed=1000 (TAA, bloom and froxel fog on), its
scene SDF baked at bake_resolution_cap=16; tests/golden_frame.npz holds
the JAX package's image and tests/test_golden.py holds the JAX package to
it. Here the port renders the same on the CPU (its plain versions), with
its own scene build and SDF bake and no JAX at all, and must meet the
same rule (tests/test_golden.py:30-31): more than 99.9% of the u8 pixels
within 2 LSB."""

from pathlib import Path

import numpy as np
import torch

from plainrenderer_tpu_torch import config
from plainrenderer_tpu_torch.assets import procedural
from plainrenderer_tpu_torch.ops import sdf_scene
from plainrenderer_tpu_torch.render import frame, scenebuild
from plainrenderer_tpu_torch.render.state import initial_state
from plainrenderer_tpu_torch.scene import camera as cam_mod

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden_frame.npz"


def render_golden_frames(n_frames: int = 3, device="cpu"):
    """tools/make_golden.py's render through the port on `device`."""
    cfg = procedural.AtriumConfig(
        columns_per_row=2, floor_subdiv=2, box_count=3, box_subdiv=1,
        column_segments=8)
    scene_data = procedural.build_atrium_scene(cfg)
    rs = scenebuild.build_render_scene(scene_data)
    scene = frame.attach_global_sdf(
        frame.scene_to_device(rs, device=device),
        sdf_scene.build_scene_sdf(rs, scene_data, bake_resolution_cap=16,
                                  device=device))
    settings = config.RenderSettings(
        width=256, height=128,
        sdf_trace=config.SDFTraceSettings(enabled=True, trace_steps=16),
        shadows=config.ShadowSettings(resolution=512),
        exposure_adaption_speed=1000.0)
    luts = frame.bake_static_luts(settings, device=device)
    state = initial_state(256, 128, device=device)
    ext = cam_mod.extrinsic_from_angles([0.0, -1.7, 0.0], pitch_deg=5.0,
                                        yaw_deg=20.0)
    cam = frame.camera_arrays(ext.position, ext.forward, ext.right, ext.up,
                              device=device)
    for _ in range(n_frames):
        image, state = frame.render_frame(state, scene, cam, luts,
                                          1.0 / 60.0, settings,
                                          device=device)
    return image.cpu().numpy(), state


def test_port_matches_golden_frame():
    img, state = render_golden_frames()
    want = np.load(GOLDEN)["image"]
    assert img.shape == want.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(np.int32) - want.astype(np.int32))
    frac_close = (diff <= 2).mean()
    assert frac_close > 0.999, (frac_close, diff.max())
    assert (state.debug_counters.numpy() == 0).all()
    # TAA, fog and the GI wrote their histories
    assert (state.taa_history.numpy() != 0).mean() > 0.5
    assert float(state.volumetric_history[3].mean()) > 0.0
    assert (state.gi_history.numpy() != 0).mean() > 0.5
