"""The port's 2-band frame against the JAX package's sharded_frame_fn.

tests/test_parallel.py's GI settings and shapes (128 x 128, 2 bands of
64 rows; SDF GI with 8 trace steps, fog, TAA, bloom and the banded
shadow atlas all on; the small textured atrium with its scene SDF baked
by the JAX package at 16^3 per mesh), so a warm JAX compile cache serves
both files. The JAX side runs under shard_map on 2 of conftest's virtual
CPU devices in interpret mode; the port's bands run on 2 gloo CPU ranks
from the same scene, LUTs and per-band states, carried over. 2 frames.
This is the one JAX sharded compile among the port's band tests, in a
file of its own."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.config import (RenderSettings, SDFTraceSettings,
                                      ShadowSettings)
from plainrenderer_tpu.ops import sdf_scene as jsdf
from plainrenderer_tpu.parallel import sharding as jsharding
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu.scene import camera as jcam
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch import interop
from plainrenderer_tpu_torch.parallel import comm, sharding
from torch_frame_checks import _arrays

torch.set_num_threads(1)

N = 2
FRAMES = 2


def test_two_band_frame_matches_jax_sharded_frame_fn():
    """The golden rule (> 99.9% of pixels within 2 LSB) on the assembled
    image; every band's debug_counters equal to the JAX band's (both
    [0, 0]: each band counts its own dropped pairs) and its exposure
    within rtol 1e-4 of the JAX band's, as the single-device frame test
    holds it (test_torch_frame.py); all bands agree on the exposure."""
    cfg = jproc.AtriumConfig(columns_per_row=2, floor_subdiv=2, box_count=3,
                             box_subdiv=1, column_segments=8)
    data = jproc.build_atrium_scene(cfg)
    rs = jsb.build_render_scene(data)
    scene = jframe.attach_global_sdf(
        jframe.scene_to_device(rs),
        jsdf.build_scene_sdf(rs, data, bake_resolution_cap=16))
    settings = RenderSettings(
        width=128, height=64 * N,
        sdf_trace=SDFTraceSettings(enabled=True, trace_steps=8),
        exposure_adaption_speed=1000.0,
        shadows=ShadowSettings(resolution=512))
    luts = jframe.bake_static_luts(settings)
    ext = jcam.extrinsic_from_angles([0.0, -1.7, 0.0], pitch_deg=5.0,
                                     yaw_deg=20.0)
    cam = jframe.camera_arrays(ext.position, ext.forward, ext.right, ext.up)
    dt = jnp.asarray(1 / 60)

    state = jsharding.initial_sharded_state(settings, N)
    t_states = [interop.band_state_from_arrays(state, r, device="cpu")
                for r in range(N)]
    t_scene = interop.scene_from_arrays(_arrays(scene), device="cpu")
    t_luts = interop.luts_from_arrays(_arrays(luts), device="cpu")
    t_cam = {k: torch.as_tensor(np.array(v)) for k, v in cam.items()}
    t_settings = tcfg.RenderSettings(
        width=128, height=64 * N,
        sdf_trace=tcfg.SDFTraceSettings(enabled=True, trace_steps=8),
        exposure_adaption_speed=1000.0,
        shadows=tcfg.ShadowSettings(resolution=512))
    runs = comm.launch(sharding.render_bands, N,
                       args=(t_settings, t_scene, t_cam, t_luts, FRAMES,
                             1 / 60, t_states),
                       device="cpu", timeout=300.0, pg_timeout=120.0)

    mesh = jsharding.make_mesh(jax.devices()[:N])
    run, _ = jsharding.sharded_frame_fn(settings, N, interpret=True)
    for _ in range(FRAMES):
        img_stacked, state = run(mesh, state, scene, cam, luts, dt)
    want = jsharding.assemble_image(img_stacked)
    got = sharding.assemble_image(torch.stack([r["image"] for r in runs]))
    assert got.shape == want.shape == (128, 128, 3)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff <= 2).mean() > 0.999, (diff <= 2).mean()
    assert want.std() > 3

    counters = np.asarray(state.debug_counters)
    exposure = np.asarray(state.exposure)
    for r, res in enumerate(runs):
        np.testing.assert_array_equal(res["debug_counters"][-1].numpy(),
                                      counters[r])
        np.testing.assert_allclose(float(res["state"].exposure),
                                   float(exposure[r]), rtol=1e-4)
    assert (counters == 0).all()
    assert len({float(r["state"].exposure) for r in runs}) == 1
