"""The port's GI block (frame.sdf_gi) against the JAX package's on the
JAX frame's own GI inputs, 3 frames of slice 3's scene
(torch_frame_checks.py)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import torch

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render.state import initial_state as j_initial_state
from plainrenderer_tpu.scene import camera as jcam
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch import interop
from plainrenderer_tpu_torch.render import frame as tframe
from torch_frame_checks import (W, H, _arrays, _f16_ulps,
                                _textured_atrium_sdf, gi_settings)

torch.set_num_threads(1)


def test_gi_block_on_jax_inputs_matches_jax_history(monkeypatch):
    """The port's GI block (frame.sdf_gi) fed, each frame, the JAX frame's
    own GI inputs (G-buffer at GI resolution, ray directions, low-res sky,
    sun, motion, depth) while it carries its own history: the GI history
    after each of test_three_frames_gi_match_jax's 3 frames is within 2
    f16 ulp of the JAX history on >= 99.9% of words. So the whole-frame
    test's wider spread comes from the inputs upstream of the GI block,
    not from the block."""
    import jax

    from plainrenderer_tpu.ops import sdfgi as j_sdfgi
    from plainrenderer_tpu.ops import taa as j_taa

    js, ts = gi_settings(jcfg), gi_settings(tcfg)
    _, rs, gsdf = _textured_atrium_sdf()
    j_scene = jframe.attach_global_sdf(jframe.scene_to_device(rs), gsdf)
    j_luts = jframe.bake_static_luts(js)
    t_scene = interop.scene_from_arrays(_arrays(j_scene), device="cpu")
    t_luts = interop.luts_from_arrays(_arrays(j_luts), device="cpu")

    # record the JAX frame's GI inputs on their way into its GI functions,
    # in a jit of a function of its own: jit reuses the trace of a function
    # it has traced before, which would skip the recorders
    seen = {}

    def recording(module, name, keep):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            jax.debug.callback(
                lambda *a: seen.__setitem__(name, [np.array(x) for x in a]),
                *(args[i] for i in keep))
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    recording(j_sdfgi, "trace_gi", (0, 1, 2, 3, 4, 10, 11, 12))
    recording(j_sdfgi, "neighborhood_resolve", (3,))
    recording(j_taa, "compute_motion", (0, 1))
    recording(j_sdfgi, "upscale_half_to_full", (2,))

    @functools.partial(jax.jit, static_argnames=("settings", "interpret"))
    def j_render(state, scene, cam, luts, delta_time, settings, interpret):
        return jframe.render_frame.__wrapped__(state, scene, cam, luts,
                                               delta_time, settings,
                                               interpret)

    j_state = j_initial_state(W, H)
    history = interop.state_from_arrays(j_state, device="cpu").gi_history
    for i in range(3):
        t_state = dataclasses.replace(
            interop.state_from_arrays(j_state, device="cpu"),
            gi_history=history)
        ext = jcam.extrinsic_from_angles([0.05 * i, -1.7, 0.02 * i],
                                         pitch_deg=5.0, yaw_deg=20.0 + 0.3 * i)
        _, j_state = j_render(
            j_state, j_scene, jframe.camera_arrays(
                ext.position, ext.forward, ext.right, ext.up),
            j_luts, jnp.asarray(0.016), js, interpret=True)
        jax.effects_barrier()
        wpos, normal, dirs, valid, sky_lowres, sun_dir, sun_col, sun_str = \
            [torch.from_numpy(a) for a in seen["trace_gi"]]
        halo = (seen["neighborhood_resolve"][0].shape[0]
                - history.shape[1]) // 2
        inp = tframe.GITraceInputs(
            valid=valid, world_pos=wpos, normal=normal,
            lin_depth=torch.from_numpy(
                seen["neighborhood_resolve"][0][halo:-halo]),
            ray_dirs=dirs, sky_lowres=sky_lowres)
        monkeypatch.setattr(tframe, "gi_trace_inputs", lambda *a: inp)
        prev_ndc, valid_full = [torch.from_numpy(a)
                                for a in seen["compute_motion"]]
        depth = torch.from_numpy(seen["upscale_half_to_full"][0])
        _, _, history = tframe.sdf_gi(
            t_state, t_scene, t_luts, ts, valid_full, None, None, depth,
            None, prev_ndc, None, sun_dir, sun_col, sun_str)
        ulps = _f16_ulps(np.asarray(j_state.gi_history), history.numpy())
        assert (ulps <= 2).mean() >= 0.999, (i, (ulps <= 2).mean())
    assert (history.numpy() != 0).mean() > 0.5
