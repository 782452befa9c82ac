"""The port's runtime (plainrenderer_tpu_torch/runtime/) against the JAX
package's: the shell classes and the stats overlay, the courtyard demo's
scene as the port's App builds it (every tensor, texture pool and alpha
masks included), two courtyard frames of the port's App against the JAX
App by the golden rule, and the reference's runtime tests ported (the
settings toggle with precompile_variants, the scripted interactive loop,
the pair-budget escalation), plus the port's escalation ceiling and its
command line on the CPU."""

import dataclasses
import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu.assets.plain_format import \
    load_binary_scene as j_load
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu.runtime import app as japp
from plainrenderer_tpu.runtime import overlay as joverlay
from plainrenderer_tpu.runtime import shell as jshell
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch import interop
from plainrenderer_tpu_torch.assets import image_io, plain_format, procedural
from plainrenderer_tpu_torch.render.state import FrameState
from plainrenderer_tpu_torch.runtime import app as tapp
from plainrenderer_tpu_torch.runtime import overlay as toverlay
from plainrenderer_tpu_torch.runtime import shell as tshell

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
COURTYARD = "assets/demo/courtyard.plain"  # its paths are repo-relative


def test_shell_matches_the_reference(monkeypatch):
    """Timer, FrameIndex, InputState and CameraController on one scripted
    clock and input sequence: every number equal."""
    ticks = [10.0, 10.016, 10.05, 10.5, 10.9, 10.91, 11.0, 11.02]
    out = {}
    for name, mod in (("jax", jshell), ("port", tshell)):
        it = iter(ticks)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda it=it: next(it)))
        timer, index = mod.Timer(), mod.FrameIndex()
        cam = mod.CameraController(position=(1.0, -2.0, 3.0), yaw=30.0)
        rows = []
        script = [({"w"}, (3.0, -2.0), True), ({"w", "shift"}, (0, 0), False),
                  ({"a", "d"}, (-400.0, 900.0), True), ({"s"}, (1, 1), True),
                  (set(), (0.5, 0.25), True), ({"d"}, (-2.0, -900.0), True),
                  ({"q"}, (0, 0), True)]
        for keys, mouse, rmb in script:
            timer.mark_new_frame()
            index.mark_new_frame()
            ext = cam.update(mod.InputState(keys_down=set(keys),
                                            mouse_movement=mouse,
                                            right_mouse_down=rmb),
                             timer.delta_time)
            rows.append([timer.delta_time, timer.time, index.index,
                         index.mod2, index.mod3, index.mod4, index.mod8,
                         cam.yaw, cam.pitch, *ext.position, *ext.forward,
                         *ext.right, *ext.up, *cam.forward_vector(),
                         *cam.right_vector()])
        out[name] = np.asarray(rows, np.float64)
    np.testing.assert_array_equal(out["port"], out["jax"])


def test_overlay_matches_the_reference():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (60, 90, 3)).astype(np.uint8)
    text = "0123456789.:/%- ABCDEFGHIKLMNOPRSTUVWXYZ abc?!"
    for scale in (1, 2, 3):
        for x, y in ((2, 3), (70, 50), (-0, 58)):
            want = joverlay.burn_text(img, text, x, y, scale=scale)
            got = toverlay.burn_text(img, text, x, y, scale=scale)
            np.testing.assert_array_equal(got, want)
        lines = ["  60.1 FPS   16.60 MS", "1920X1080  GI:ON",
                 "MEM   123.4 MB  EXP 0.00081", "OVERFLOW MAIN 3 SHADOW 0"]
        np.testing.assert_array_equal(
            toverlay.burn_stats(img, lines, scale=scale),
            joverlay.burn_stats(img, lines, scale=scale))


# ------------------------------ the courtyard ------------------------------

def _demo_settings(cfg):
    """tests/test_demo_asset.py's settings (the JAX frame program is the
    same one that test compiles)."""
    return cfg.RenderSettings(
        width=256, height=128,
        sdf_trace=cfg.SDFTraceSettings(enabled=True, trace_steps=8),
        volumetrics=cfg.VolumetricsSettings(enabled=False),
        shadows=cfg.ShadowSettings(resolution=512),
        exposure_adaption_speed=1000.0)


@functools.lru_cache(maxsize=1)
def _port_courtyard():
    return tapp.App(_demo_settings(tcfg), COURTYARD, with_gi=True,
                    device="cpu")


def _arrays(d):
    out = {}
    for k, v in d.items():
        if k == "sdf_coarse":
            out[k] = (np.asarray(v[0]), np.asarray(v[1]), v[2], v[3])
        elif k == "sdf_voxel_size":
            out[k] = v
        else:
            out[k] = np.asarray(v)
    return out


def test_courtyard_scene_matches_the_reference(monkeypatch):
    """The port's App on courtyard.plain: the 3 DDS volumes read, none
    baked; every tensor of its scene dict, the texture pool words and the
    alpha masks included, equal to the JAX package's scene_to_device of
    its build_render_scene with the SDF composited as its App does
    (app.py:75-112, which reads nothing of self), carried across by
    interop. Every textured mesh's albedo, normal and specular texture
    reached the pool: no file was dropped."""
    monkeypatch.chdir(REPO)
    app = _port_courtyard()
    assert (app.sdf_loaded, app.sdf_baked) == (3, 0)
    data = j_load(COURTYARD)
    rs = jsb.build_render_scene(data)
    gsdf = japp.App._load_or_bake_sdf(None, rs, data, None)
    want = interop.scene_from_arrays(_arrays(jframe.attach_global_sdf(
        jframe.scene_to_device(rs), gsdf)), device="cpu")
    assert sorted(app.scene) == sorted(want)
    assert "alpha_masks" in want and "tex_word0" in want
    for k, v in want.items():
        got = app.scene[k]
        if k == "sdf_coarse":
            for a, b in zip(got[:2], v[:2]):
                assert torch.equal(a, b), k
            assert got[2:] == v[2:]
        elif isinstance(v, torch.Tensor):
            assert got.dtype == v.dtype and torch.equal(got, v), k
        else:
            assert got == v, k
    # the JAX side read every texture with PIL: the equal pool words say
    # the port's reader dropped none; and each file the meshes name loads
    assert (app.scene["mat_tex"] >= 0).all()
    for m in data.meshes:
        for p in (m.texture_paths.albedo, m.texture_paths.normal,
                  m.texture_paths.specular):
            assert p and image_io.load_image(p).shape[2] == 4


def _courtyard_pair():
    """The port's App and the JAX App (interpret=True) on the courtyard
    at tests/test_demo_asset.py's settings and camera, delta time 1/60
    on both."""
    t_app = _port_courtyard()
    j_app = japp.App(_demo_settings(jcfg), COURTYARD, with_gi=True,
                     interpret=True)
    lo = t_app.scene["object_bb_min"].numpy().min(0)
    hi = t_app.scene["object_bb_max"].numpy().max(0)
    center = (lo + hi) * 0.5
    for app in (t_app, j_app):
        app.camera.position = np.asarray(
            [lo[0] - 0.6 * (hi[0] - lo[0]), center[1], center[2]],
            np.float32)
        app.camera.yaw = 0.0
        app.camera.pitch = 0.0
        app.timer = types.SimpleNamespace(mark_new_frame=lambda: None,
                                          delta_time=1.0 / 60.0)
    return t_app, j_app


def _golden(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float((diff <= 2).mean())


def test_two_courtyard_frames_match_the_reference(monkeypatch):
    """Two run_frames of the port's App against the JAX App's as its
    users run it (render_frame under jax.jit): debug_counters zero and
    exposure within 1e-4 on both frames; frame 0's coverage equal on every
    pixel, its depth within 1e-5 relative on >= 99.9% of pixels and within
    1e-3 on the rest (the raster rule: the jitted raster contracts its
    plane evaluations, so a pixel on a shared edge can take the other
    triangle) and its image within 2 LSB on >= 98.5% of pixels.

    The golden rule (> 99.9%) holds against the JAX App's frames computed
    op by op (render_frame.__wrapped__): every pixel of both frames within
    1 LSB (compare_courtyard_op_by_op below, too slow for tier 1). Under
    jax.jit the JAX frame differs from its own op-by-op result on this
    scene: XLA:CPU contracts multiply-adds, so in frame 0 the GI of the
    floor's far rows (rows 72-95) moves (0.990 of pixels within 2 LSB of
    the op-by-op frame), and in frame 1 jax.jit's geometry setup finds a
    nonzero area for the zero-area padding triangles at the origin and
    rasterizes them (19.56% of the image covered against 13.62%)."""
    monkeypatch.chdir(REPO)
    t_app, j_app = _courtyard_pair()
    for i in range(2):
        t_img = t_app.run_frame().numpy()
        j_img = np.asarray(j_app.run_frame())
        assert t_img.shape == (128, 256, 3) and t_img.dtype == np.uint8
        assert 2 < t_img.mean() < 253 and t_img.std() > 5
        assert not np.asarray(j_app.state.debug_counters).any()
        assert not t_app.state.debug_counters.numpy().any()
        np.testing.assert_allclose(float(t_app.state.exposure),
                                   float(j_app.state.exposure), rtol=1e-4)
        if i == 0:
            t_d = t_app.state.prev_depth.numpy()
            j_d = np.asarray(j_app.state.prev_depth)
            np.testing.assert_array_equal(t_d > 0, j_d > 0)
            assert np.isclose(t_d, j_d, rtol=1e-5, atol=0).mean() >= 0.999
            np.testing.assert_allclose(t_d, j_d, rtol=1e-3, atol=0)
            assert _golden(t_img, j_img) >= 0.985, _golden(t_img, j_img)


def compare_courtyard_op_by_op():
    """The golden rule against the JAX App run op by op: its render_frame
    without jax.jit (the Pallas kernels still compiled in interpret mode),
    two frames; prints each frame's share of pixels within 1 and 2 LSB,
    the same against the JAX App under jax.jit, the jitted frames against
    the op-by-op ones, and the share of pixels each covers (depth > 0).
    ~5 min on one CPU core: run it from the repository root as
    PYTHONPATH=. python tests/test_torch_runtime.py."""
    import os

    os.chdir(REPO)
    t_app, op_app = _courtyard_pair()
    _, jit_app = _courtyard_pair()
    jitted = jframe.render_frame
    for i in range(2):
        t_img = t_app.run_frame().numpy()
        j_img = np.asarray(jit_app.run_frame())
        jframe.render_frame = jitted.__wrapped__
        try:
            o_img = np.asarray(op_app.run_frame())
        finally:
            jframe.render_frame = jitted
        diff = np.abs(t_img.astype(np.int32) - o_img.astype(np.int32))
        cover = [float((np.asarray(a.state.prev_depth) > 0).mean())
                 for a in (t_app, op_app, jit_app)]
        print(f"frame {i}: port vs op-by-op JAX {(diff <= 1).mean():.6f} "
              f"of pixels within 1 LSB, {(diff <= 2).mean():.6f} within 2 "
              f"(max {diff.max()}); port vs jitted JAX "
              f"{_golden(t_img, j_img):.6f}, jitted vs op-by-op JAX "
              f"{_golden(j_img, o_img):.6f} within 2; covered: port "
              f"{cover[0]:.4f}, op-by-op {cover[1]:.4f}, jitted "
              f"{cover[2]:.4f}")
        assert (diff <= 2).mean() > 0.999


# ---------------------- the reference's runtime tests ----------------------

def _box_plain(tmp_path, name, count=1, size=(4.0, 1.0, 4.0)):
    meshes, objs = [], []
    for i in range(count):
        mesh = procedural.box_mesh(*size)
        mesh.texture_paths = plain_format.TexturePaths()
        mesh.mean_albedo = (0.5, 0.5, 0.5)
        meshes.append(mesh)
        objs.append(plain_format.ObjectBinary(
            model_matrix=np.eye(4, dtype="float32"), mesh_index=i))
    path = tmp_path / name
    plain_format.save_binary_scene(path, plain_format.scene_to_binary(
        plain_format.Scene(objects=objs, meshes=meshes)))
    return path


def _tiny_app(tmp_path):
    """test_runtime.py:36-61's tiny box scene."""
    settings = tcfg.RenderSettings(
        width=256, height=128,
        sdf_trace=tcfg.SDFTraceSettings(enabled=False),
        volumetrics=tcfg.VolumetricsSettings(enabled=False),
        shadows=tcfg.ShadowSettings(resolution=512))
    return tapp.App(settings, str(_box_plain(tmp_path, "tiny.plain")),
                    with_gi=False, device="cpu")


def _state_bits(state):
    return {f.name: getattr(state, f.name).clone()
            for f in dataclasses.fields(FrameState)}


def test_app_toggle_and_precompile(tmp_path):
    """set_settings swaps variants at runtime; precompile_variants renders
    each variant once on a copy of the state and leaves app.state as it
    was, bit for bit."""
    app = _tiny_app(tmp_path)
    settings = app.settings
    img0 = app.run_frame().numpy()
    assert img0.shape == (128, 256, 3)
    before = _state_bits(app.state)
    variant = dataclasses.replace(settings, draw_bounding_boxes=True)
    app.precompile_variants([variant, dataclasses.replace(
        settings, width=128, height=64)])
    for k, v in _state_bits(app.state).items():
        assert torch.equal(v, before[k]), k
    app.set_settings(variant)
    img1 = app.run_frame().numpy()
    assert (img1 != img0).any()  # wireframes drawn
    assert (img1 == (255, 255, 0)).all(axis=-1).sum() > 50
    app.set_settings(settings)
    app.run_frame()


def test_interactive_loop_scripted(tmp_path):
    """interactive_loop on a scripted command stream: movement, mouse-look,
    a settings toggle and quit change the settings and the camera, and
    latest.png is presented."""
    app = _tiny_app(tmp_path)
    pos0 = np.array(app.camera.position, np.float32).copy()
    yaw0 = app.camera.yaw
    assert not app.settings.draw_bounding_boxes
    out = tmp_path / "frames"
    out.mkdir()
    script = ["w 2", "look 15 0", "aabb", "", "bogus_command", "q"]
    tapp.interactive_loop(app, out, overlay=True, overlay_scale=1,
                          max_frames=5, command_stream=script)
    assert app.settings.draw_bounding_boxes
    assert image_io.load_image(out / "latest.png").shape == (128, 256, 4)
    pos1 = np.array(app.camera.position, np.float32)
    assert np.linalg.norm(pos1 - pos0) > 1.0
    assert app.camera.yaw != yaw0


def test_pair_budget_auto_escalation(tmp_path):
    """48 coincident boxes filling the view overflow the default budget:
    App doubles pair_budget_scale until a frame renders with zero
    overflow (test_runtime.py:127-174)."""
    settings = tcfg.RenderSettings(
        width=256, height=128,
        sdf_trace=tcfg.SDFTraceSettings(enabled=False),
        volumetrics=tcfg.VolumetricsSettings(enabled=False),
        taa=tcfg.TAASettings(enabled=False),
        shadows=tcfg.ShadowSettings(cascade_count=0))
    path = _box_plain(tmp_path, "stack.plain", count=48, size=(6.0, 3.0, 6.0))
    app = tapp.App(settings, str(path), with_gi=False, device="cpu")
    app.camera.position = np.asarray([0.0, -1.0, -4.5], np.float32)
    assert app.settings.pair_budget_scale == 1.0
    clean = False
    for _ in range(6):
        app.run_frame()
        if not app.state.debug_counters.numpy().any():
            clean = True
            break
    assert app.settings.pair_budget_scale > 1.0
    assert clean


def test_pair_budget_escalation_stops_at_the_ceiling(tmp_path, capsys):
    """2,000 coincident front-facing triangles (and 2,000 back-facing) in
    the one 32 x 128 bin of a 128 x 32 frame: past the bin's pair cap
    (MAX_PAIRS_PER_TILE - GROUP = 1,920) 80 pairs drop at any budget. The
    scale doubles to MAX_PAIR_BUDGET_SCALE, then stays there with a
    warning while the drops go on."""
    n = 2000
    front = np.asarray([[-50, 50, 0], [50, 50, 0], [0, -50, 0]], np.float32)
    tris = np.concatenate([np.tile(front, (n, 1)),
                           np.tile(front[::-1], (n, 1))])
    normal = np.tile([[0.0, 0.0, -1.0]], (len(tris), 1)).astype(np.float32)
    mesh = plain_format.MeshData(
        indices=np.arange(len(tris), dtype=np.uint32), positions=tris,
        normals=normal, tangents=np.roll(normal, 1, axis=1),
        bitangents=np.roll(normal, 2, axis=1),
        uvs=np.zeros((len(tris), 2), np.float32))
    path = tmp_path / "wall.plain"
    plain_format.save_binary_scene(path, plain_format.scene_to_binary(
        plain_format.Scene(objects=[plain_format.ObjectBinary(
            np.eye(4, dtype=np.float32), 0)], meshes=[mesh])))
    off = dict(enabled=False)
    settings = tcfg.RenderSettings(
        width=128, height=32, sdf_trace=tcfg.SDFTraceSettings(**off),
        volumetrics=tcfg.VolumetricsSettings(**off),
        taa=tcfg.TAASettings(**off), bloom=tcfg.BloomSettings(**off),
        shadows=tcfg.ShadowSettings(cascade_count=0))
    app = tapp.App(settings, str(path), with_gi=False, device="cpu")
    app.camera.position = np.asarray([0.0, 0.0, -5.0], np.float32)
    scales = []
    for _ in range(6):
        app.run_frame()
        scales.append(app.settings.pair_budget_scale)
    assert scales == [2.0, 4.0, 8.0, 16.0, 16.0, 16.0]
    assert tapp.MAX_PAIR_BUDGET_SCALE == 16.0
    assert app.state.debug_counters.numpy().tolist() == [n - 1920, 0]
    assert "the ceiling 16" in capsys.readouterr().err


def test_main_writes_frames_and_needs_a_gpu(tmp_path, monkeypatch):
    """The command line on the CPU (--cpu) writes its frames as PNGs the
    port reads back; without --cpu and with no GPU it raises."""
    path = _box_plain(tmp_path, "tiny.plain")
    out = tmp_path / "frames"
    tapp.main(["256", "128", str(path), "--cpu", "--no-gi", "--frames", "2",
               "--out", str(out), "--cam", "0", "-1", "-5", "--yaw", "90",
               "--pitch", "0"])
    frames = sorted(out.glob("frame_*.png"))
    assert [p.name for p in frames] == ["frame_0000.png", "frame_0001.png"]
    img = image_io.load_image(frames[-1])
    assert img.shape == (128, 256, 4) and img[..., :3].std() > 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tapp.main(["256", "128", str(path), "--no-gi", "--frames", "1",
                   "--out", str(out)])


if __name__ == "__main__":
    compare_courtyard_op_by_op()
