"""The JAX package's remaining public helpers in the port, against the JAX
package (following its own tests, tests/test_camera_frustum.py,
test_color.py, test_sampling.py and test_brdf_sh_tonemap.py), and a guard
against gaps: every public top-level name of every JAX module has a
counterpart in the port's module of the same path, but for one list of
exceptions with their reasons.

Rules: integer hashes and the host numpy generators bit-exact; matrices,
frustums and curves within 1e-5 relative (XLA:CPU's eager dot and
transcendentals against PyTorch's, a few f32 ulps); the culling and
pyramid results exact."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.ops import hiz as jhiz
from plainrenderer_tpu.ops import sky as jsky
from plainrenderer_tpu.scene import aabb as jaabb
from plainrenderer_tpu.scene import camera as jcam
from plainrenderer_tpu.scene import frustum as jfr
from plainrenderer_tpu.utils import color as jcolor
from plainrenderer_tpu.utils import mathutils as jmath
from plainrenderer_tpu.utils import noise as jnoise
from plainrenderer_tpu.utils import tonemap as jtone
from plainrenderer_tpu_torch.assets import procedural as tproc
from plainrenderer_tpu_torch.ops import hiz as thiz
from plainrenderer_tpu_torch.ops import sky as tsky
from plainrenderer_tpu_torch.scene import aabb as taabb
from plainrenderer_tpu_torch.scene import camera as tcam
from plainrenderer_tpu_torch.scene import frustum as tfr
from plainrenderer_tpu_torch.utils import color as tcolor
from plainrenderer_tpu_torch.utils import mathutils as tmath
from plainrenderer_tpu_torch.utils import noise as tnoise
from plainrenderer_tpu_torch.utils import tonemap as ttone

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _cameras():
    """The JAX test's default camera (origin, looking down -z, 16:9) and
    a turned, moved one at another fov and aspect, on both sides."""
    out = []
    for pos, pitch, yaw, fov, aspect in (
            ([0.0, 0.0, 0.0], None, None, 35.0, 16 / 9),
            ([1.5, -2.0, 3.0], 12.0, 40.0, 60.0, 1.3)):
        cams = []
        for mod in (jcam, tcam):
            c = mod.Camera()
            c.intrinsic.fov, c.intrinsic.aspect_ratio = fov, aspect
            if pitch is None:
                c.extrinsic.position = np.asarray(pos, np.float32)
            else:
                e = mod.extrinsic_from_angles(pos, pitch, yaw)
                c.extrinsic = mod.CameraExtrinsic(
                    position=e.position, forward=e.forward, right=e.right,
                    up=e.up)
            cams.append(c)
        out.append(cams)
    return out


def test_camera_matrices_match_jax():
    for jc, tc in _cameras():
        np.testing.assert_allclose(
            tcam.view_projection(tc, device="cpu").numpy(),
            np.asarray(jcam.view_projection(jc)), rtol=RTOL, atol=1e-6)
        jit = np.float32([0.31, -0.2])
        np.testing.assert_allclose(
            tcam.view_projection(tc, jitter_ndc=jit, device="cpu").numpy(),
            np.asarray(jcam.view_projection(jc, jitter_ndc=jnp.asarray(jit))),
            rtol=RTOL, atol=1e-6)
        e = tc.extrinsic
        np.testing.assert_allclose(
            tcam.view_matrix_from_extrinsic(e.position, e.forward, e.right,
                                            e.up, device="cpu").numpy(),
            np.asarray(jcam.view_matrix_from_extrinsic(
                e.position, e.forward, e.right, e.up)), rtol=RTOL, atol=1e-6)
    # reverse-Z (the JAX test's rule): near -> 1, far -> 0
    tc = _cameras()[0][1]
    vp = tcam.view_projection(tc, device="cpu").numpy()
    for z, want in ((-tc.intrinsic.near, 1.0), (-tc.intrinsic.far, 0.0)):
        v = vp @ np.float32([0, 0, z, 1])
        assert abs(v[2] / v[3] - want) < 1e-5
    np.testing.assert_allclose(
        tcam.look_at([1, -2, 3], [0, 0, 0], [0, -1, 0], device="cpu").numpy(),
        np.asarray(jcam.look_at([1, -2, 3], [0, 0, 0], [0, -1, 0])),
        rtol=RTOL, atol=1e-6)
    p = tcam.projection_matrix_from_intrinsic(35.0, 1.5, 0.1, 300.0,
                                              device="cpu")
    jittered = tcam.apply_projection_jitter(p, [0.5, 0.25])
    assert float(jittered[0, 2]) == 0.5 and float(p[0, 2]) == 0.0


def test_frustums_and_culling_match_jax():
    rng = np.random.default_rng(4)
    mins = rng.uniform(-300, 300, (200, 3)).astype(np.float32)
    mins[:4] = [[-1, -1, -11], [-1, -1, 9], [500, -1, -11], [-1, -1, -400]]
    maxs = mins + rng.uniform(0.5, 30, (200, 3)).astype(np.float32)
    for jc, tc in _cameras():
        jf = jfr.compute_view_frustum(jc)
        tf = tfr.compute_view_frustum(tc, device="cpu")
        for name in ("points", "plane_points", "plane_normals"):
            np.testing.assert_allclose(getattr(tf, name).numpy(),
                                       np.asarray(getattr(jf, name)),
                                       rtol=RTOL, atol=1e-4)
        vis = tfr.aabb_intersects_frustum(tf, _t(mins), _t(maxs)).numpy()
        if not jc.extrinsic.position.any():  # the JAX test's four boxes
            assert vis[:4].tolist() == [True, False, False, False]
        np.testing.assert_array_equal(
            vis, np.asarray(jfr.aabb_intersects_frustum(
                jf, jnp.asarray(mins), jnp.asarray(maxs))))
        assert 0 < vis.sum() < len(vis)
        light = np.float32([0.2, 0.9, 0.1])
        light /= np.linalg.norm(light)
        jo = jfr.compute_ortho_frustum_fitted_to_camera(jf, jnp.asarray(light))
        to = tfr.compute_ortho_frustum_fitted_to_camera(tf, light)
        np.testing.assert_allclose(to.points.numpy(), np.asarray(jo.points),
                                   rtol=1e-4, atol=1e-3)
        # the fit contains the camera frustum (the JAX test's rule)
        d = ((tf.points[:, None] - to.plane_points[None])
             * to.plane_normals[None]).sum(-1)
        assert bool((d <= 1e-2).all())


def test_aabb_helpers_match_jax():
    rng = np.random.default_rng(6)
    pts = (rng.random((50, 3)) * 4 - 2).astype(np.float32)
    t_min, t_max = taabb.aabb_from_positions(_t(pts))
    j_min, j_max = jaabb.aabb_from_positions(jnp.asarray(pts))
    np.testing.assert_array_equal(t_min.numpy(), np.asarray(j_min))
    np.testing.assert_array_equal(t_max.numpy(), np.asarray(j_max))
    angle = 0.7
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                 [-np.sin(angle), 0, np.cos(angle)]]
    m[:3, 3] = [1, 2, 3]
    mats = np.stack([m, np.eye(4, dtype=np.float32)])
    got = taabb.aabb_transformed(t_min[None].expand(2, 3),
                                 t_max[None].expand(2, 3), _t(mats))
    want = jaabb.aabb_transformed(jnp.broadcast_to(j_min, (2, 3)),
                                  jnp.broadcast_to(j_max, (2, 3)),
                                  jnp.asarray(mats))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[0][1].numpy(), pts.min(0))


def test_color_helpers_match_jax():
    c = np.linspace(-0.1, 1.2, 1000, dtype=np.float32)
    np.testing.assert_allclose(tcolor.srgb_to_linear(_t(c)).numpy(),
                               np.asarray(jcolor.srgb_to_linear(
                                   jnp.asarray(c))), rtol=RTOL, atol=1e-7)
    unit = torch.linspace(0.0, 1.0, 256)  # the JAX test's round trip
    back = tcolor.srgb_to_linear(tcolor.linear_to_srgb(unit))
    np.testing.assert_allclose(back.numpy(), unit.numpy(), atol=2e-5)
    uv = np.stack(np.meshgrid(np.arange(64.0), np.arange(64.0)),
                  -1).astype(np.float32)
    got = tcolor.interleaved_gradient_noise(_t(uv)).numpy()
    want = np.asarray(jcolor.interleaved_gradient_noise(jnp.asarray(uv)))
    assert (got >= 0).all() and (got <= 1).all() and got.std() > 0.2
    # mod(62.98 x mod(d, 1), 1) magnifies an ulp of d 63 times
    assert (np.abs(got - want) <= 1e-4).mean() >= 0.999
    rng = np.random.default_rng(8)
    seeds = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    seeds[:4] = [0, 1, 2 ** 32 - 1, 61]
    ts, js = _t(seeds.astype(np.int64)), jnp.asarray(seeds)
    for name in ("wang_hash", "xorshift32"):
        np.testing.assert_array_equal(
            getattr(tcolor, name)(ts).numpy(),
            np.asarray(getattr(jcolor, name)(js)).astype(np.int64))
    (tv, tst), (jv, jst) = tcolor.rand_from_state(ts), \
        jcolor.rand_from_state(js)
    np.testing.assert_array_equal(tst.numpy(),
                                  np.asarray(jst).astype(np.int64))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    px = rng.integers(0, 1920, (40, 50)).astype(np.int32)
    py = rng.integers(0, 1080, (40, 50)).astype(np.int32)
    h = tcolor.hash32(_t(px), _t(py)).numpy()
    np.testing.assert_array_equal(h, np.asarray(jcolor.hash32(
        jnp.asarray(px), jnp.asarray(py))))
    assert h.shape == (40, 50, 3) and h.std() > 0.1
    col = rng.random((40, 50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tcolor.dither_rgb8(_t(col), _t(px), _t(py),
                           torch.tensor(0.416)).numpy(),
        np.asarray(jcolor.dither_rgb8(jnp.asarray(col), jnp.asarray(px),
                                      jnp.asarray(py), jnp.asarray(0.416))))


@pytest.mark.parametrize("seed", [0, 3])
def test_noise_generators_bit_exact(seed):
    np.testing.assert_array_equal(
        tnoise.generate_white_noise((17, 40), seed),
        jnoise.generate_white_noise((17, 40), seed))
    np.testing.assert_array_equal(
        tnoise.generate_perlin_2d((33, 48), 8, seed),
        jnoise.generate_perlin_2d((33, 48), 8, seed))
    np.testing.assert_array_equal(
        tnoise.generate_perlin_3d((9, 16, 20), 4, seed),
        jnoise.generate_perlin_3d((9, 16, 20), 4, seed))


def test_tonemap_curves_match_jax():
    x = np.linspace(0.0, 40.0, 3000, dtype=np.float32).reshape(1000, 3)
    np.testing.assert_allclose(
        ttone.aces_film_approximate(_t(x)).numpy(),
        np.asarray(jtone.aces_film_approximate(jnp.asarray(x))), rtol=RTOL,
        atol=1e-7)
    got = ttone.aces_fitted(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtone.aces_fitted(
        jnp.asarray(x))), rtol=RTOL, atol=1e-7)
    assert np.abs(ttone.aces_fitted(torch.zeros(3)).numpy()).max() < 1e-4
    assert (ttone.aces_fitted(torch.full((3,), 100.0)).numpy() > 0.99).all()


def test_math_hiz_sky_and_procedural_helpers_match_jax():
    for size in ((1920, 1080), (1, 1), (513, 7, 3), (4096, 2048)):
        assert tmath.mip_count_from_resolution(*size) == \
            jmath.mip_count_from_resolution(*size)
        for mip in range(4):
            assert tmath.resolution_from_mip(size, mip) == \
                jmath.resolution_from_mip(size, mip)
    rng = np.random.default_rng(10)
    v = rng.normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_allclose(tmath.dot2(_t(v)).numpy(),
                               np.asarray(jmath.dot2(jnp.asarray(v))),
                               rtol=RTOL)
    depth = rng.random((64, 96)).astype(np.float32)
    depth[:8] = 0.0  # sky rows stay out of the min
    got = thiz.build_min_max_pyramid(_t(depth))
    want = jhiz.build_min_max_pyramid(jnp.asarray(depth))
    assert len(got) == len(want) == 5  # 32x48 .. 2x3, then 3 is odd
    for (a_min, a_max), (b_min, b_max) in zip(got, want):
        np.testing.assert_array_equal(a_min.numpy(), np.asarray(b_min))
        np.testing.assert_array_equal(a_max.numpy(), np.asarray(b_max))
    cos = np.linspace(-1, 1, 101, dtype=np.float32)
    for g in (0.0, 0.3, -0.6):
        np.testing.assert_allclose(
            tsky.phase_greenstein(_t(cos), g).numpy(),
            np.asarray(jsky.phase_greenstein(jnp.asarray(cos), g)),
            rtol=RTOL)
    lut = rng.random((3, 16, 24)).astype(np.float32)
    u, w = (rng.uniform(-0.1, 1.1, (30, 7)).astype(np.float32)
            for _ in range(2))
    got = tsky.bilinear_lookup_matmul(_t(lut), _t(u), _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsky.bilinear_lookup_matmul(
        jnp.asarray(lut), jnp.asarray(u), jnp.asarray(w))), rtol=RTOL,
        atol=1e-6)
    np.testing.assert_allclose(
        got, tsky.bilinear_lookup(_t(lut), _t(u), _t(w)).numpy(), atol=1e-6)
    cfg = dict(columns_per_row=2, floor_subdiv=2, box_count=3, box_subdiv=1,
               column_segments=8)
    assert tproc.triangle_count(tproc.build_atrium_scene(
        tproc.AtriumConfig(**cfg))) == jproc.triangle_count(
        jproc.build_atrium_scene(jproc.AtriumConfig(**cfg)))


# ------------------------------ the gap guard ------------------------------

# JAX modules and names the port leaves out on purpose, with the reason
EXCEPTIONS = {
    "ops/gatherlib.py": "TPU-only lane-gather helpers of the Pallas kernels "
                        "(ROADMAP North star: the CUDA kernels index memory)",
    "ops/scanlib.py": "TPU-only exact prefix sum (ROADMAP North star: "
                      "torch.cumsum is exact on integers)",
    "native/__init__.py": "the C++ SDF baker; assets/sdf_bake.bake_mesh_sdf "
                          "takes its place (ROADMAP Queue 1 item 5)",
}


def _top_level(path: Path, with_imports: bool) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for t in ast.walk(target):
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_every_public_jax_name_has_a_counterpart_in_the_port():
    """Walks plainrenderer_tpu/ with ast (no JAX import): each public
    top-level function, class and assignment of a module has a name in
    the port's module of the same path (defined or imported there), but
    for EXCEPTIONS."""
    jax_root = REPO / "plainrenderer_tpu"
    port_root = REPO / "plainrenderer_tpu_torch"
    missing, excused = [], set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        names = _top_level(path, with_imports=False)
        if rel in EXCEPTIONS:
            excused.add(rel)
            continue
        port = port_root / rel
        have = _top_level(port, with_imports=True) if port.exists() \
            else set()
        for name in sorted(names):
            key = f"{rel}:{name}"
            if key in EXCEPTIONS:
                excused.add(key)
            elif name not in have:
                missing.append(key)
    assert not missing, missing
    # every exception still names something the JAX package has
    assert excused == set(EXCEPTIONS), set(EXCEPTIONS) - excused
    sharding = _top_level(jax_root / "parallel" / "sharding.py", False)
    assert {n for n in sharding if n.islower()} == {
        "assemble_image", "band_settings", "initial_sharded_state",
        "make_mesh", "sharded_frame_fn"}
