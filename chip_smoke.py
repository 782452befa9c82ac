#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Run from the repository root with one CUDA device visible:

    python3 chip_smoke.py

What it does, in order; any failed check raises and the script exits
non-zero without printing its final line:

 1. prints the card's name and power limit (nvidia-smi) and builds the
    CUDA kernels of plainrenderer_tpu_torch/csrc (nvcc, sm_90a, one
    process per source, all started together);
 2. slice 1: the bench's untextured atrium (292,672 triangles) at
    1920x1080 on the bench camera path with shadows, SDF GI, TAA and
    bloom off. Kernels A (pair keys) and C (material lookup) must equal
    their plain PyTorch versions exactly at a real frame's shapes, kernel
    B (G-buffer) by the CPU tests' rule; a small scene (3 frames at
    256x128) on the card must match the CPU plain path (> 99.9% of pixels
    within 2 LSB); then 1 warm-up + 3 timed frames with the launch counts
    reset just before and read just after;
 3. slice 2: the textured atrium without banners (292,416 triangles, 41
    textures) with the default sun shadows (3 cascades of 2048^2, 12 PCF
    taps), fog, GI, TAA and bloom off. pair_budget_scale is the smallest
    power of two that drops no pair over the whole camera path (printed).
    At frame 0's shapes kernel D (texture sampling) must match its plain
    version (ok equal, values within 1e-5), kernel E (shadow-atlas depth)
    and kernel A's multi-view keys exactly, kernel F (PCF resolve) on
    >= 99.9% of pixels with the rest within 1/taps; the small textured,
    shadowed scene card vs CPU by the golden rule; then 1 warm-up + 3
    timed frames with per-pass CUDA events, counts reset just before and
    read just after: A twice per frame, B-F at least once;
 4. slice 3: the same scene and shadows with SDF GI on
    (SDFTraceSettings(): half resolution, 128 steps, influence 3, coarse
    fallback), its scene SDF baked on the card by build_scene_sdf at
    bake_resolution_cap=32 (bench.py:93-95). Kernel G (GI trace) on frame
    0's trace inputs: escaped and the hit/miss decision equal to its plain
    version on >= 99.9% of rays, the six value channels within 1e-4 (abs
    + rel) where both agree; kernel H (history resample) on frame 1's
    history: ok equal on every pixel, values within 1e-6 of their taps'
    magnitude; the small slice-3 scene card vs CPU by the golden rule; 3
    warm-up + 8 timed frames with the counts reset just before and read
    just after: A twice per frame, B-H at least once; the escaped share
    and the GI history after them (an all-zero history fails);
 5. times every kernel, its plain version and, where one exists, one
    PyTorch call computing the same function (CUDA events), and computes
    each kernel's bound from this run's inputs;
 6. checks the frames of every slice (debug_counters [0, 0], no host
    synchronisation in a timed frame, image mean in (2, 253) and std > 5,
    finite HDR, exposure > 0) and profiles 2 more slice-3 frames;
 7. prints the per-pass times, the card line, the kernels line (launches
    from the slice-3 run) and, last, {"ok": true, "device": {...}}.

Everything also goes to chiprun_out/chip_smoke/ as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): HBM3
# bandwidth and non-tensor FP32. INT32: Hopper issues 64 INT32 ops per SM
# per clock, half its 128 FP32 lanes, so half the FP32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = FP32_OPS_PER_S / 2

WIDTH, HEIGHT = 1920, 1080
S1_WARMUP, S1_TIMED = 1, 3
S2_WARMUP, S2_TIMED = 1, 3
S3_WARMUP, S3_TIMED = 3, 8
KERNEL_SOURCES = {
    "expand_keys": ("plainrenderer_tpu_torch/csrc/expand_keys.cu",
                    "plainrenderer_tpu/ops/raster.py:406"),
    "gbuffer": ("plainrenderer_tpu_torch/csrc/gbuffer.cu",
                "plainrenderer_tpu/ops/raster.py:1564"),
    "material": ("plainrenderer_tpu_torch/csrc/material.cu",
                 "plainrenderer_tpu/ops/post.py:69"),
    "texture": ("plainrenderer_tpu_torch/csrc/texture.cu",
                "plainrenderer_tpu/ops/texture.py:47"),
    "depth": ("plainrenderer_tpu_torch/csrc/depth.cu",
              "plainrenderer_tpu/ops/raster.py:1465"),
    "shadow": ("plainrenderer_tpu_torch/csrc/shadow.cu",
               "plainrenderer_tpu/ops/shadow.py:167"),
    "sdfgi_trace": ("plainrenderer_tpu_torch/csrc/sdfgi.cu",
                    "plainrenderer_tpu/ops/sdfgi.py:112"),
    "packed_planes": ("plainrenderer_tpu_torch/csrc/packed_planes.cu",
                      "plainrenderer_tpu/ops/taa.py:277"),
}
# operations of one step of kernel G's loops and of a ray's fixed work,
# counted from csrc/sdfgi.cu (float and integer ops alike): the fine step
# (position, window coords, clamp, inside/excess, brick address, s8
# decode, hit/exit tests, step), a shadow step, a coarse step, and per
# ray the setup, refinement, albedo, pow, sky mapping and SH encode
G_FINE_STEP_OPS, G_SHADOW_STEP_OPS, G_COARSE_STEP_OPS = 60, 45, 35
G_RAY_OPS = 150
SLICE1_KERNELS = ("expand_keys", "gbuffer", "material")
SMALL_ATRIUM = dict(columns_per_row=2, floor_subdiv=2, box_count=3,
                    box_subdiv=1, column_segments=8)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms per call of fn over reps calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def slice1_settings(cfg, width, height):
    return cfg.RenderSettings(
        width=width, height=height,
        shadows=cfg.ShadowSettings(cascade_count=0),
        sdf_trace=cfg.SDFTraceSettings(enabled=False),
        taa=cfg.TAASettings(enabled=False),
        bloom=cfg.BloomSettings(enabled=False))


def slice2_settings(cfg, width, height, **shadows):
    """The default ShadowSettings (3 cascades, 2048^2, 12 taps); fog runs
    only with shadows and is a later slice, so it is off."""
    return dataclasses.replace(
        slice1_settings(cfg, width, height),
        shadows=cfg.ShadowSettings(**shadows),
        volumetrics=cfg.VolumetricsSettings(enabled=False))


def slice3_settings(cfg, width, height, **shadows):
    """Slice 2 with the default SDFTraceSettings() (GI on)."""
    return dataclasses.replace(slice2_settings(cfg, width, height, **shadows),
                               sdf_trace=cfg.SDFTraceSettings())


def bench_camera(frame, cam_mod, t: int, device):
    """bench.py:105-110's flight path."""
    import numpy as np

    ext = cam_mod.extrinsic_from_angles(
        [-9.0 + 0.02 * t, -1.8, 0.3 * np.sin(t * 0.05)],
        pitch_deg=8.0, yaw_deg=10.0 + t * 0.1)
    return frame.camera_arrays(ext.position, ext.forward, ext.right, ext.up,
                               device=device)


def evaluated_pair_pixels(pair_edges, pairs, n_tiles_x: int, sub: int):
    """(pair, pixel) plane evaluations a row-skipping raster kernel does on
    these pair lists: each pair meets the 16-px sub-rows of its bin inside
    its [fy0, fy1] (pair_edges rows 3 and 7), 2048 pixels each."""
    import torch

    dev = pair_edges.device
    counts = pairs.tile_count.long()
    seg = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                  counts)
    first = torch.repeat_interleave(pairs.tile_start.long(), counts)
    rank = torch.arange(seg.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    stream = first + rank
    fy0, fy1 = pair_edges[3, stream], pair_edges[7, stream]
    row0 = (seg // n_tiles_x * sub).float()
    sub_rows = (torch.minimum(fy1, row0 + sub - 1)
                - torch.maximum(fy0, row0) + 1).clamp(min=0)
    return float(sub_rows.sum()) * 2048


def drive(mods, scene, cams, luts, settings, dev, warmup: int, timed: int):
    """One main-path run: launch counts reset just before, read just after;
    per-pass CUDA events on the timed frames, which also run under
    torch.cuda's sync debug mode to count the host synchronisations the
    frame makes (none expected)."""
    import numpy as np
    import torch

    frame, native, initial_state, PassTimer = (
        mods["frame"], mods["native"], mods["initial_state"],
        mods["PassTimer"])
    state = initial_state(settings.width, settings.height, device=dev)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    timers, counters, image = [], [], None
    t_wall = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(warmup + timed):
            if i == warmup:
                torch.cuda.synchronize()
                t_wall = time.perf_counter()
                torch.cuda.set_sync_debug_mode("warn")
            timer = PassTimer() if i >= warmup else None
            image, state = frame.render_frame(state, scene, cams[i], luts,
                                              1.0 / 60.0, settings,
                                              device=dev, timer=timer)
            counters.append(state.debug_counters)
            if timer is not None:
                timers.append(timer)
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t_wall) * 1e3 / max(timed, 1)
    launches = native.launch_counts()
    pass_ms = {}
    if timers:
        passes = [t.intervals() for t in timers]
        pass_ms = {n: {"mean": float(np.mean([p[n] for p in passes])),
                       "min": float(np.min([p[n] for p in passes]))}
                   for n in sorted(passes[0])}
        pass_ms["host_wall_per_frame"] = {"mean": wall_ms}
    return {"launches": launches, "pass_ms": pass_ms, "state": state,
            "host_syncs_per_frame": syncs / max(timed, 1),
            "counters": torch.stack(counters).cpu().numpy(), "image": image,
            "frames": warmup + timed}


def check_frames(run: dict, width: int, height: int, what: str) -> dict:
    import numpy as np
    import torch

    counters = run["counters"]
    check((counters == 0).all(), f"{what}: debug_counters all zero: "
          f"{counters.tolist()}")
    image, state = run["image"], run["state"]
    last = image.float()
    mean, std = float(last.mean()), float(last.std())
    exposure = float(state.exposure)
    print(f"{what}: image {tuple(image.shape)} mean {mean:.2f} std "
          f"{std:.2f}; exposure {exposure:.4e}; debug_counters "
          f"{counters[-1].tolist()}", flush=True)
    check(tuple(image.shape) == (height, width, 3), f"{what}: image shape")
    check(2.0 < mean < 253.0 and std > 5.0,
          f"{what}: image not empty or saturated")
    check(np.isfinite(exposure) and exposure > 0.0, f"{what}: exposure")
    check(bool(torch.isfinite(state.prev_color).all()), f"{what}: finite HDR")
    return {"image_mean": mean, "image_std": std, "exposure": exposure}


def check_launches(run: dict, per_frame: dict, what: str) -> None:
    n = run["frames"]
    print(f"{what}: launches over {n} frames: {run['launches']}; host "
          f"syncs per timed frame {run['host_syncs_per_frame']}", flush=True)
    check(run["host_syncs_per_frame"] == 0,
          f"{what}: the frame never waits for the device")
    for name, k in per_frame.items():
        check(run["launches"][name] >= k * n,
              f"{what}: kernel {name} launched {k}x per frame")


def small_card_vs_cpu(mods, settings, textured: bool, luts,
                      gi: bool = False) -> float:
    """3 frames of the small atrium at 256x128 on the card (kernels) and on
    the CPU (plain versions): the share of u8 pixels within 2 LSB. With
    gi, the scene SDF is baked on the card at 16^3 per mesh and attached
    on both sides, and the camera moves a little every frame (a static
    camera puts the history window's edge test on exact ties, where
    rounding noise in the motion decides)."""
    import numpy as np

    frame, scenebuild, procedural, cam_mod = (
        mods["frame"], mods["scenebuild"], mods["procedural"],
        mods["cam_mod"])
    scene_data = procedural.build_atrium_scene(
        procedural.AtriumConfig(**SMALL_ATRIUM), textured=textured)
    rs = scenebuild.build_render_scene(scene_data)
    gsdf = mods["sdf_scene"].build_scene_sdf(
        rs, scene_data, bake_resolution_cap=16, device="cuda") if gi else None
    images = []
    for d in ("cuda", "cpu"):
        sc = frame.scene_to_device(rs, device=d)
        if gi:
            sc = frame.attach_global_sdf(sc, gsdf)
        lt = {k: v.to(d) for k, v in luts.items()}
        st = mods["initial_state"](256, 128, device=d)
        for i in range(3):
            k = i if gi else 0
            ext = cam_mod.extrinsic_from_angles(
                [0.05 * k, -1.7, 0.02 * k], pitch_deg=5.0,
                yaw_deg=20.0 + 0.3 * k)
            cm = frame.camera_arrays(ext.position, ext.forward, ext.right,
                                     ext.up, device=d)
            img, st = frame.render_frame(st, sc, cm, lt, 0.016, settings,
                                         device=d)
        images.append(img.cpu().numpy().astype(np.int32))
        if textured:
            check((st.debug_counters.cpu().numpy() == 0).all(),
                  f"small scene debug_counters on {d}")
    return float((np.abs(images[0] - images[1]) <= 2).mean())


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "measures the GPU port and has no CPU mode", file=sys.stderr)
        return 2
    from plainrenderer_tpu_torch import config, native
    from plainrenderer_tpu_torch.assets import procedural
    from plainrenderer_tpu_torch.assets.textures import MAX_MIPS
    from plainrenderer_tpu_torch.ops import post, raster, sdf_scene, sdfgi
    from plainrenderer_tpu_torch.ops import shade, shadow, taa, texture
    from plainrenderer_tpu_torch.render import frame, scenebuild
    from plainrenderer_tpu_torch.render.state import initial_state
    from plainrenderer_tpu_torch.scene import camera as cam_mod
    from plainrenderer_tpu_torch.utils.timing import PassTimer

    mods = dict(frame=frame, native=native, initial_state=initial_state,
                PassTimer=PassTimer, scenebuild=scenebuild,
                procedural=procedural, cam_mod=cam_mod, sdf_scene=sdf_scene)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")
    report = {"card": smi}
    t_start = time.time()

    t0 = time.time()
    lib_path = native.build()
    native.library()
    report["build_s"] = time.time() - t0
    print(f"build: {report['build_s']:.1f} s -> {lib_path}", flush=True)
    (OUT / "ptxas.log").write_text(
        (lib_path.parent / "ptxas.log").read_text()
        if (lib_path.parent / "ptxas.log").exists() else "cached build\n")

    ms, plain_ms, library_ms, bounds, errors = {}, {}, {}, {}, {}

    # ================= slice 1: the untextured atrium =================
    t0 = time.time()
    cfg = procedural.AtriumConfig(columns_per_row=6, column_segments=64,
                                  floor_subdiv=64, box_count=12,
                                  box_subdiv=16, banner_count=4)
    rs = scenebuild.build_render_scene(
        procedural.build_atrium_scene(cfg, textured=False))
    check(rs.triangle_count == 292_672, f"triangles {rs.triangle_count}")
    check(rs.material_table.shape[0] == 45, "45 materials")
    settings = slice1_settings(config, WIDTH, HEIGHT)
    scene = frame.scene_to_device(rs, device=dev)
    luts = frame.bake_static_luts(settings, device=dev)
    cams = [bench_camera(frame, cam_mod, t, dev)
            for t in range(S3_WARMUP + S3_TIMED)]
    torch.cuda.synchronize()
    print(f"slice 1 scene: {rs.triangle_count} triangles, {rs.object_count}"
          f" objects; setup {time.time() - t0:.1f} s", flush=True)

    mv = frame.main_view_setup(scene, cams[0], settings)
    ki = raster.pair_key_inputs(mv.setup, mv.n_tiles_y, mv.n_tiles_x,
                                mv.pair_budget, mv.sub, order_rows=True)
    keys_k, own_k = raster.expand_keys(ki)
    keys_p, own_p = raster.expand_keys_plain(ki)
    check(torch.equal(keys_k, keys_p) and torch.equal(own_k, own_p),
          "kernel A keys/owners equal the plain version")
    err_a = float((keys_k.long() - keys_p.long()).abs().max())
    live_pairs = int(ki.cum[-1])
    print(f"kernel A: {ki.budget} slots, {live_pairs} live, T={ki.tpv}: "
          "equal", flush=True)

    pairs, pe, pa, depth_k, vis_k, gbuf_k = frame.raster_main_view(mv)
    check(int(pairs.overflow) == 0, "no pairs dropped at the bench framing")
    depth_p, vis_p, gbuf_p = raster.gbuffer_plain(
        pe, pa, pairs.tile_start, pairs.tile_count, mv.n_tiles_y,
        mv.n_tiles_x, mv.sub, True)
    ids_k = raster.winner_triangle_ids(vis_k, pairs, mv.n_tiles_x, mv.sub)
    ids_p = raster.winner_triangle_ids(vis_p, pairs, mv.n_tiles_x, mv.sub)
    frac_differ = float(((ids_k != ids_p) | (depth_k != depth_p))
                        .float().mean())
    both = (ids_k >= 0) & (ids_k == ids_p)
    err_b = float((gbuf_k - gbuf_p).abs()[:, both].max())
    covered = float((vis_k >= 0).float().mean())
    print(f"kernel B: {frac_differ:.3e} of pixels differ (limit 1e-3), "
          f"channels max |err| {err_b:.3e} (limit 1e-4), "
          f"{covered:.3f} covered", flush=True)
    check(frac_differ <= 1e-3, "kernel B winners/depth vs plain")
    check(err_b <= 1e-4, "kernel B channels vs plain")
    check(covered > 0.3, "the frame covers the screen")

    mat_id = torch.floor(gbuf_k[raster._CH_MAT] * 0.5)
    valid = vis_k >= 0
    table = post.material_table_lanes(scene["material_table"])
    mat_k = post.material_kernel(table, mat_id, valid)
    mat_p = post.material_plain(table, mat_id, valid)
    check(torch.equal(mat_k, mat_p), "kernel C equals the plain version")
    err_c = float((mat_k - mat_p).abs().max())
    print("kernel C: equal", flush=True)

    small1 = dataclasses.replace(slice1_settings(config, 256, 128),
                                 exposure_adaption_speed=1000.0)
    close1 = small_card_vs_cpu(mods, small1, False, luts)
    print(f"small slice-1 scene card vs CPU plain: {close1:.5f} of pixels "
          "within 2 LSB (limit > 0.999)", flush=True)
    check(close1 > 0.999, "small slice-1 image card vs CPU")

    n_pix = mv.n_tiles_y * mv.sub * raster.TILE_H * mv.n_tiles_x * \
        raster.TILE_W
    ms.update({
        "expand_keys": cuda_ms(lambda: raster.expand_keys(ki), 50),
        "gbuffer": cuda_ms(lambda: raster.rasterize_gbuffer(
            pe, pa, pairs, mv.n_tiles_y, mv.n_tiles_x, sub=mv.sub,
            row_skip=True), 20),
        "material": cuda_ms(
            lambda: post.material_kernel(table, mat_id, valid), 50)})
    plain_ms.update({
        "expand_keys": cuda_ms(lambda: raster.expand_keys_plain(ki), 10),
        "gbuffer": cuda_ms(lambda: raster.gbuffer_plain(
            pe, pa, pairs.tile_start, pairs.tile_count, mv.n_tiles_y,
            mv.n_tiles_x, mv.sub, True), 2),
        "material": cuda_ms(
            lambda: post.material_plain(table, mat_id, valid), 20)})
    # yardstick for kernel C: one PyTorch gather of the same table rows
    # (pixel-major output; the id clip and valid select are folded into a
    # precomputed index into a table with a zero row 128)
    table_rows = torch.cat([table.T, torch.zeros(1, table.shape[0],
                                                 device=dev)])
    gather_idx = torch.where(valid, mat_id.long().clamp(0, 127),
                             128).reshape(-1)
    library_ms.update({
        "expand_keys": None, "gbuffer": None,
        "material": cuda_ms(
            lambda: table_rows.index_select(0, gather_idx), 50)})
    t_count, budget = ki.tpv, ki.budget
    a_bytes = 4 * (3 * t_count + 2 * budget)
    a_ops = live_pairs * (3 * max(1, int(np.ceil(np.log2(t_count)))) + 20)
    n_pairs = pe.shape[1]
    b_bytes = 4 * (pe.shape[0] + pa.shape[0]) * n_pairs \
        + 8 * pairs.tile_start.shape[0] + n_pix * 4 * (2 + 13)
    evaluated = evaluated_pair_pixels(pe, pairs, mv.n_tiles_x, mv.sub)
    # 4 planes x (mul + add + add) per evaluated (pair, pixel) + about 80
    # flops of attribute evaluation per covered pixel
    b_ops = 12 * evaluated + 80 * float((vis_k >= 0).sum())
    c_bytes = n_pix * (4 + 1 + 4 * table.shape[0]) + table.numel() * 4
    bounds.update({
        "expand_keys": (a_bytes / HBM_BYTES_PER_S, a_ops / INT32_OPS_PER_S),
        "gbuffer": (b_bytes / HBM_BYTES_PER_S, b_ops / FP32_OPS_PER_S),
        "material": (c_bytes / HBM_BYTES_PER_S, 0.0)})
    errors.update({"expand_keys": err_a, "gbuffer": err_b,
                   "material": err_c})

    run1 = drive(mods, scene, cams, luts, settings, dev, S1_WARMUP, S1_TIMED)
    check_launches(run1, {k: 1 for k in SLICE1_KERNELS}, "slice 1")
    for k in ("texture", "depth", "shadow", "sdfgi_trace", "packed_planes"):
        check(run1["launches"][k] == 0, f"slice 1 runs no {k} kernel")
    print("slice 1 passes_ms " + json.dumps(run1["pass_ms"]), flush=True)
    frames1 = check_frames(run1, WIDTH, HEIGHT, "slice 1")
    report["slice1"] = dict(
        passes_ms=run1["pass_ms"], launches=run1["launches"],
        host_syncs_per_frame=run1["host_syncs_per_frame"],
        frames=run1["frames"], gbuffer_pixels_differ=frac_differ,
        small_close=close1, live_pairs=live_pairs, pair_budget=budget,
        evaluated_pair_pixels=evaluated, **frames1)
    del scene, pairs, pe, pa, gbuf_k, gbuf_p, mat_k, mat_p, run1

    # ====== slice 2: the textured atrium with cascaded sun shadows ======
    t0 = time.time()
    cfg2 = dataclasses.replace(cfg, banner_count=0)
    scene_data2 = procedural.build_atrium_scene(cfg2, textured=True)
    rs2 = scenebuild.build_render_scene(scene_data2)
    check(rs2.triangle_count == 292_416, f"triangles {rs2.triangle_count}")
    n_tex = rs2.tex_info.shape[0] // MAX_MIPS
    check(rs2.material_table.shape[0] == 41 and n_tex == 41,
          "41 materials, 41 textures")
    check(rs2.alpha_masks is None, "no alpha-tested geometry")
    scene2 = frame.scene_to_device(rs2, device=dev)
    torch.cuda.synchronize()
    print(f"slice 2 scene: {rs2.triangle_count} triangles, {n_tex} "
          f"textures, {rs2.tex_word0.shape[0]} bricks; setup "
          f"{time.time() - t0:.1f} s", flush=True)

    # smallest power-of-two pair budget scale that drops nothing over the
    # camera path (the JAX app escalates the same way, runtime/app.py:197)
    scale = 1.0
    while True:
        settings2 = slice2_settings(config, WIDTH, HEIGHT)
        settings2 = dataclasses.replace(settings2, pair_budget_scale=scale)
        probe = drive(mods, scene2, cams, luts, settings2, dev,
                      len(cams), 0)
        dropped = probe["counters"].max(axis=0).tolist()
        print(f"pair_budget_scale {scale}: most dropped per frame "
              f"(main, atlas) {dropped}", flush=True)
        if max(dropped) == 0:
            break
        scale *= 2.0
        check(scale <= 64.0, "pair budget scale bounded")
    del probe
    n_cas = settings2.shadows.cascade_count
    sres = settings2.shadows.resolution
    taps = settings2.shadows.pcf_taps

    mv2 = frame.main_view_setup(scene2, cams[0], settings2)
    pairs2, pe2, pa2, depth2, vis2, gbuf2 = frame.raster_main_view(mv2)
    valid2 = vis2 >= 0
    mat_id2 = torch.floor(gbuf2[raster._CH_MAT] * 0.5)
    pw, ph = raster.pad_resolution(WIDTH, HEIGHT)
    n_pix2 = pw * ph

    # kernel D at the frame's shapes
    targs = (gbuf2[raster._CH_U:raster._CH_U + 2],
             gbuf2[raster._CH_DUDX:raster._CH_DUDX + 4], mat_id2, valid2,
             scene2["mat_tex"], scene2["tex_info"], scene2["tex_word0"],
             scene2["tex_word1"])
    tex_k = texture.sample_materials(*targs, n_mips=MAX_MIPS)
    tex_p = texture.sample_plain(*targs, MAX_MIPS)
    ok_k, ok_p = tex_k[8] > 0.5, tex_p[8] > 0.5
    both_ok = ok_k & ok_p
    val_err = (tex_k[:8] - tex_p[:8]).abs().amax(dim=0)
    err_d = float(val_err[both_ok].max()) if bool(both_ok.any()) else 0.0
    bad_px = (ok_k != ok_p) | (both_ok & (val_err > 1e-5))
    tiles_differ = float(texture.to_thread_layout(bad_px).flatten(1)
                         .any(dim=1).float().mean())
    ok_share = float(ok_k[valid2].float().mean())
    print(f"kernel D: ok equal on {float((ok_k == ok_p).float().mean()):.6f}"
          f" of pixels, values max |err| {err_d:.3e} (limit 1e-5), "
          f"{tiles_differ:.3e} of tiles differ; {ok_share:.4f} of covered "
          "pixels textured", flush=True)
    check(bool((ok_k == ok_p).all()), "kernel D ok channel vs plain")
    check(err_d <= 1e-5, "kernel D values vs plain")
    check(ok_share > 0.5, "most covered pixels are textured")
    mat_t = texture.to_thread_layout(mat_id2).to(torch.int32)
    n_valid_t, dom_t, _, needs2_t = texture.tile_materials(
        mat_t, texture.to_thread_layout(valid2), scene2["mat_tex"])
    windows = int(((scene2["mat_tex"][dom_t.long()] >= 0)
                   & (n_valid_t > 0)).sum() + needs2_t.sum())

    # shadow atlas: kernel A's multi-view keys and kernel E
    atlas = frame.render_shadow_atlas(scene2, cams[0], depth2, settings2)
    check(int(atlas.pairs.overflow) == 0, "no atlas pairs dropped")
    ki2 = raster.pair_key_inputs(atlas.setup, atlas.n_bins_y,
                                 atlas.n_bins_x, atlas.pair_budget,
                                 atlas.sub, order_rows=True, n_views=n_cas)
    keys2_k, own2_k = raster.expand_keys(ki2)
    keys2_p, own2_p = raster.expand_keys_plain(ki2)
    check(torch.equal(keys2_k, keys2_p) and torch.equal(own2_k, own2_p),
          "kernel A multi-view keys equal the plain version")
    atlas_live = int(ki2.cum[-1])
    print(f"kernel A (atlas, {n_cas} views): {ki2.budget} slots, "
          f"{atlas_live} live, T/view={ki2.tpv}: equal", flush=True)
    eargs = (atlas.edges, atlas.pairs, atlas.n_bins_y, atlas.n_bins_x)
    depth_e = raster.rasterize_depth(*eargs, sub=atlas.sub, row_skip=True)
    depth_ep = raster.depth_plain(
        atlas.edges, atlas.pairs.tile_start, atlas.pairs.tile_count,
        atlas.n_bins_y, atlas.n_bins_x, atlas.sub, True)
    check(torch.equal(depth_e.view(torch.int32),
                      depth_ep.view(torch.int32)),
          "kernel E atlas equals the plain version")
    err_e = float((depth_e - depth_ep).abs().max())
    atlas_cov = float((depth_e > 0).float().mean())
    counts_e = atlas.pairs.tile_count
    print(f"kernel E: {n_cas} x {sres}^2 atlas equal; {atlas_cov:.3f} "
          f"covered; pairs per bin max {int(counts_e.max())} mean "
          f"{float(counts_e.float().mean()):.1f}", flush=True)

    # kernel F at the frame's shapes
    inv_vp = torch.linalg.inv_ex(mv2.view_proj).inverse
    world_pos2 = shade.reconstruct_world_position(depth2, inv_vp, pw, ph)
    to_cam = cams[0]["position"].reshape(3, 1, 1) - world_pos2
    pix_depth = torch.where(valid2, -torch.sum(
        to_cam * cams[0]["forward"].reshape(3, 1, 1), dim=0), 0.0)
    noise = frame.blue_noise_screen(
        luts, torch.zeros((), dtype=torch.int32, device=dev), ph, pw)
    fargs = (world_pos2, pix_depth, noise, atlas.maps, atlas.cascade_mats,
             atlas.cascade_scales, atlas.splits, n_cas)
    radius = settings2.shadows.sample_radius
    sh_k = shadow.shadow_resolve(*fargs, taps=taps, sample_radius=radius)
    maps_packed = shadow.pack_shadow_maps_u16(atlas.maps)
    rows = shadow.cascade_rows(atlas.cascade_mats, atlas.cascade_scales,
                               atlas.splits)
    pargs = (world_pos2, pix_depth, noise, maps_packed, rows, n_cas, taps,
             radius)
    sh_p = shadow.shadow_resolve_plain(*pargs, sres)
    diff_f = (sh_k - sh_p).abs()
    f_equal = float((diff_f == 0).float().mean())
    err_f = float(diff_f.max())
    shadowed = float((sh_k[valid2] < 0.5).float().mean())
    print(f"kernel F: {f_equal:.6f} of pixels equal (limit 0.999), max "
          f"|err| {err_f:.4f} (limit 1/{taps}); {shadowed:.3f} of covered "
          "pixels in shadow", flush=True)
    check(f_equal >= 0.999, "kernel F vs plain")
    check(err_f <= 1.0 / taps + 1e-6, "kernel F error bound")
    check(0.01 < shadowed < 0.99, "the frame has light and shadow")

    small2 = dataclasses.replace(
        slice2_settings(config, 256, 128, resolution=256),
        exposure_adaption_speed=1000.0)
    close2 = small_card_vs_cpu(mods, small2, True, luts)
    print(f"small slice-2 scene card vs CPU plain: {close2:.5f} of pixels "
          "within 2 LSB (limit > 0.999)", flush=True)
    check(close2 > 0.999, "small slice-2 image card vs CPU")

    # timings of the slice-2 kernels and their plain versions
    ms.update({
        "texture": cuda_ms(lambda: texture.sample_materials(
            *targs, n_mips=MAX_MIPS), 20),
        "depth": cuda_ms(lambda: raster.rasterize_depth(
            *eargs, sub=atlas.sub, row_skip=True), 20),
        "shadow": cuda_ms(lambda: shadow.resolve_packed(*pargs), 20)})
    plain_ms.update({
        "texture": cuda_ms(lambda: texture.sample_plain(
            *targs, MAX_MIPS), 3),
        "depth": cuda_ms(lambda: raster.depth_plain(
            atlas.edges, atlas.pairs.tile_start, atlas.pairs.tile_count,
            atlas.n_bins_y, atlas.n_bins_x, atlas.sub, True), 1),
        "shadow": cuda_ms(
            lambda: shadow.shadow_resolve_plain(*pargs, sres), 3)})
    # no single PyTorch call computes a windowed, fallback-masked brick
    # sample, a clamped depth-max raster or a window-clamped PCF
    library_ms.update({"texture": None, "depth": None, "shadow": None})
    atlas_a_ms = cuda_ms(lambda: raster.expand_keys(ki2), 50)
    atlas_a_plain_ms = cuda_ms(lambda: raster.expand_keys_plain(ki2), 10)
    t_atlas = ki2.cum.shape[0]
    atlas_a_bound = max(
        4 * (3 * t_atlas + 2 * ki2.budget) / HBM_BYTES_PER_S,
        atlas_live * (3 * max(1, int(np.ceil(np.log2(t_atlas)))) + 20)
        / INT32_OPS_PER_S) * 1e3

    # bounds from this run's inputs: D reads uv, 4 derivatives, id and
    # valid (29 B) and writes 9 f32 (36 B) per pixel, plus one 24x256
    # window of both words per sampled (tile, material); E writes the
    # atlas and reads each pair's 16 rows and each bin's start/count; F
    # reads position, linear depth and noise (20 B), writes 4 B per pixel
    # and reads the used cascades' packed maps
    d_bytes = n_pix2 * 65 + windows * texture.WIN_H * texture.WIN_W * 8
    e_eval = evaluated_pair_pixels(atlas.edges, atlas.pairs,
                                   atlas.n_bins_x, atlas.sub)
    e_bytes = (n_cas * sres * sres * 4 + 16 * 4 * atlas.edges.shape[1]
               + 8 * atlas.pairs.tile_count.shape[0])
    f_bytes = n_pix2 * 24 + n_cas * (sres // 2) * sres * 4
    # F: per tap ~24 flops (rotation, offset, round, compare) per pixel
    f_ops = float(valid2.sum()) * taps * 24
    bounds.update({
        "texture": (d_bytes / HBM_BYTES_PER_S, 0.0),
        "depth": (e_bytes / HBM_BYTES_PER_S, 12 * e_eval / FP32_OPS_PER_S),
        "shadow": (f_bytes / HBM_BYTES_PER_S, f_ops / FP32_OPS_PER_S)})
    errors.update({"texture": err_d, "depth": err_e, "shadow": err_f})
    del tex_p, depth_ep, sh_p

    # the slice-2 main path: counts reset, 1 warm-up + 3 timed frames
    run2 = drive(mods, scene2, cams, luts, settings2, dev, S2_WARMUP,
                 S2_TIMED)
    check_launches(run2, {"expand_keys": 2, "gbuffer": 1, "material": 1,
                          "texture": 1, "depth": 1, "shadow": 1},
                   "slice 2")
    print("slice 2 passes_ms " + json.dumps(run2["pass_ms"]), flush=True)
    frames2 = check_frames(run2, WIDTH, HEIGHT, "slice 2")
    for k in ("sdfgi_trace", "packed_planes"):
        check(run2["launches"][k] == 0, f"slice 2 runs no {k} kernel")
    report["slice2"] = dict(
        passes_ms=run2["pass_ms"], launches=run2["launches"],
        host_syncs_per_frame=run2["host_syncs_per_frame"],
        frames=run2["frames"], pair_budget_scale=scale,
        small_close=close2, texture_tiles_differ=tiles_differ,
        texture_ok_share=ok_share, texture_windows=windows,
        shadow_equal_share=f_equal, shadowed_share=shadowed,
        atlas_live_pairs=atlas_live, atlas_pair_budget=atlas.pair_budget,
        atlas_covered=atlas_cov, atlas_evaluated_pair_pixels=e_eval,
        atlas_pairs_per_bin={
            "max": int(counts_e.max()),
            "mean": float(counts_e.float().mean()),
            "nonzero_bins": int((counts_e > 0).sum())},
        **frames2)
    del run2, atlas, tex_k, sh_k

    # ============ slice 3: SDF-traced diffuse GI on the card ============
    t0 = time.time()
    gsdf = sdf_scene.build_scene_sdf(rs2, scene_data2, bake_resolution_cap=32,
                                     device=dev)
    torch.cuda.synchronize()
    bake_s = time.time() - t0
    scene3 = frame.attach_global_sdf(scene2, gsdf)
    grid = scene3["sdf_grid"]
    n_bricks = scene3["sdf_volume"].shape[0]
    sdf_bytes = (scene3["sdf_volume"].nbytes + scene3["sdf_albedo"].nbytes)
    c_dims, c_f = scene3["sdf_coarse"][2:]
    print(f"slice 3 scene SDF: baked on the card in {bake_s:.1f} s; grid "
          f"{gsdf.volume.shape} at {gsdf.voxel_size} m -> padded {grid}, "
          f"{n_bricks} bricks, {sdf_bytes / 1e6:.2f} MB packed; coarse "
          f"{c_dims} (factor {c_f})", flush=True)
    settings3 = dataclasses.replace(slice3_settings(config, WIDTH, HEIGHT),
                                    pair_budget_scale=scale)
    print(f"slice 3 settings: {settings3.sdf_trace}; pair_budget_scale "
          f"{scale}", flush=True)

    # frame 0's trace inputs and frame 1's history inputs, recorded on
    # their way into kernels G and H
    recorded = {}
    trace_fn, resample_fn = frame.trace_scene_gi, taa.resample_packed_planes

    def record_trace(*args, **kwargs):
        recorded.setdefault("trace", args)
        return trace_fn(*args, **kwargs)

    def record_resample(*args, **kwargs):
        recorded.setdefault("history", []).append(args)
        return resample_fn(*args, **kwargs)

    frame.trace_scene_gi, taa.resample_packed_planes = (record_trace,
                                                        record_resample)
    try:
        state3 = initial_state(WIDTH, HEIGHT, device=dev)
        for i in range(2):
            _, state3 = frame.render_frame(state3, scene3, cams[i], luts,
                                           1.0 / 60.0, settings3, device=dev)
    finally:
        frame.trace_scene_gi, taa.resample_packed_planes = (trace_fn,
                                                            resample_fn)
    t_scene, inp, t_settings, sun_dir, sun_col, sun_str = recorded["trace"]
    st3 = t_settings.sdf_trace
    g_args = (inp.world_pos, inp.normal, inp.ray_dirs, inp.valid,
              inp.sky_lowres, t_scene["sdf_volume"], t_scene["sdf_albedo"],
              t_scene["sdf_origin"], t_scene["sdf_voxel_size"],
              t_scene["sdf_grid"], sun_dir, sun_col, sun_str)
    g_kw = dict(steps=st3.trace_steps, influence=st3.influence_radius * 2.5,
                strict=st3.strict_influence_radius_cutoff,
                dims_zyx=t_scene["sdf_grid"],
                coarse_fallback=st3.coarse_fallback,
                coarse_tables=t_scene["sdf_coarse"])
    gh, gw = inp.valid.shape
    n_rays = gh * gw
    y_k, c_k, e_k = sdfgi.trace_gi(*g_args, **g_kw)
    g_stats = {}
    y_p, c_p, e_p = sdfgi.trace_gi(*g_args, plain=True, stats=g_stats,
                                   **g_kw)
    ref = torch.cat([y_p, c_p, e_p[None]])
    out_k = torch.cat([y_k, c_k])
    # the hit/miss decision: again with the sky shifted below 0 by its
    # maximum + 1, where a miss reads negative Y and a hit never does
    sky_shift = float(inp.sky_lowres.max()) + 1.0
    shifted = g_args[:4] + (inp.sky_lowres - sky_shift,) + g_args[5:]
    hit_k = sdfgi.trace_gi(*shifted, **g_kw)[0][0] >= 0
    hit_p = sdfgi.trace_gi(*shifted, plain=True, **g_kw)[0][0] >= 0
    valid3 = inp.valid
    same_esc = e_k == ref[6]
    same_hit = hit_k == hit_p
    esc_equal = float(same_esc.float().mean())
    hit_equal = float(same_hit[valid3].float().mean())
    both = same_esc & same_hit
    err_g = float((out_k - ref[:6]).abs()[:, both].max())
    excess_g = float(((out_k - ref[:6]).abs() - 1e-4 * ref[:6].abs())
                     [:, both].max())
    escaped_share = float(e_k[valid3].mean())
    hit_share = float(hit_k[valid3].float().mean())
    print(f"kernel G: {gh}x{gw} rays ({int(valid3.sum())} on surfaces); "
          f"escaped equal on {esc_equal:.6f}, hit/miss on {hit_equal:.6f} "
          f"(limit 0.999); values max |err| {err_g:.3e} (limit 1e-4 abs + "
          f"rel); {hit_share:.4f} of rays hit, {escaped_share:.4f} escaped "
          f"the window; loop steps {g_stats}", flush=True)
    check(esc_equal >= 0.999 and hit_equal >= 0.999,
          "kernel G escaped / hit decision vs plain")
    check(excess_g <= 1e-4, "kernel G values vs plain")
    check(0.0 < hit_share < 1.0, "the GI rays both hit and miss")

    planes_h, motion_h, width_h, height_h = recorded["history"][1]
    coords_h = taa.reprojected_coords(motion_h, width_h, height_h)
    hist_k = taa.packed_planes(planes_h, coords_h)
    hist_p = taa.packed_planes_plain(planes_h, coords_h)
    magnitude = taa.packed_planes_plain(planes_h & 0x7FFF7FFF, coords_h)
    ok_equal = bool(torch.equal(hist_k[6], hist_p[6]))
    err_h = float((hist_k[:6] - hist_p[:6]).abs().max())
    excess_h = float(((hist_k[:6] - hist_p[:6]).abs()
                      - 1e-6 * magnitude[:6]).max())
    ok_share = float(hist_k[6].mean())
    hist_nonzero = float((planes_h != 0).float().mean())
    print(f"kernel H: {tuple(planes_h.shape)} history ({hist_nonzero:.4f} "
          f"of words nonzero); ok equal: {ok_equal}, values max |err| "
          f"{err_h:.3e} (limit 1e-6 of the taps' magnitude); {ok_share:.4f} "
          "of pixels reproject inside the window", flush=True)
    check(hist_nonzero > 0.1, "frame 1's GI history is not empty")
    check(ok_equal, "kernel H ok channel vs plain")
    check(excess_h <= 0.0, "kernel H values vs plain")

    small3 = dataclasses.replace(
        slice3_settings(config, 256, 128, resolution=256),
        exposure_adaption_speed=1000.0)
    close3 = small_card_vs_cpu(mods, small3, True, luts, gi=True)
    print(f"small slice-3 scene card vs CPU plain: {close3:.5f} of pixels "
          "within 2 LSB (limit > 0.999)", flush=True)
    check(close3 > 0.999, "small slice-3 image card vs CPU")

    # timings of G and H, their plain versions and H's library yardstick
    ms["sdfgi_trace"] = cuda_ms(lambda: sdfgi.trace_gi(*g_args, **g_kw), 20)
    plain_ms["sdfgi_trace"] = cuda_ms(
        lambda: sdfgi.trace_gi(*g_args, plain=True, **g_kw), 2)
    ms["packed_planes"] = cuda_ms(lambda: taa.packed_planes(planes_h,
                                                            coords_h), 50)
    plain_ms["packed_planes"] = cuda_ms(
        lambda: taa.packed_planes_plain(planes_h, coords_h), 10)
    # no PyTorch call sphere-traces a bricked SDF; grid_sample computes H's
    # bilinear resample (without the window clamp) on the unpacked planes
    hh, hw = planes_h.shape[1:]
    unpacked = torch.stack([c for p in planes_h
                            for c in taa.unpack_f16_pair_flush(p)])[None]
    grid_h = torch.stack([coords_h[0] / hw * 2.0 - 1.0,
                          coords_h[1] / hh * 2.0 - 1.0], dim=-1)[None]
    library_ms["sdfgi_trace"] = None
    library_ms["packed_planes"] = cuda_ms(
        lambda: torch.nn.functional.grid_sample(
            unpacked, grid_h, mode="bilinear", padding_mode="border",
            align_corners=False), 50)
    # G's bytes from this run's inputs: every ray reads its valid flag
    # (1 B) and writes 7 f32; only a valid ray reads its position, normal
    # and direction (9 f32); plus the bricks, the sky and the coarse tables
    n_valid = int(valid3.sum())
    sky_bytes = inp.sky_lowres.nbytes
    coarse_bytes = sum(t.nbytes for t in t_scene["sdf_coarse"][:2])
    g_bytes = (inp.valid.element_size() * n_rays + 7 * 4 * n_rays
               + 9 * 4 * n_valid + sdf_bytes + sky_bytes + coarse_bytes)
    g_ops = (G_FINE_STEP_OPS * g_stats["fine_steps"]
             + G_SHADOW_STEP_OPS * g_stats["shadow_steps"]
             + G_COARSE_STEP_OPS * (g_stats["coarse_steps"]
                                    + g_stats["coarse_shadow_steps"])
             + G_RAY_OPS * g_stats["rays"])
    h_bytes = 48 * hh * hw
    bounds.update({
        "sdfgi_trace": (g_bytes / HBM_BYTES_PER_S, g_ops / FP32_OPS_PER_S),
        "packed_planes": (h_bytes / HBM_BYTES_PER_S, 0.0)})
    errors.update({"sdfgi_trace": err_g, "packed_planes": err_h})
    del ref, hist_p, magnitude, unpacked

    # the slice-3 main path: counts reset, 3 warm-up + 8 timed frames
    run3 = drive(mods, scene3, cams, luts, settings3, dev, S3_WARMUP,
                 S3_TIMED)
    check_launches(run3, {"expand_keys": 2, "gbuffer": 1, "material": 1,
                          "texture": 1, "depth": 1, "shadow": 1,
                          "sdfgi_trace": 1, "packed_planes": 1}, "slice 3")
    print("slice 3 passes_ms " + json.dumps(run3["pass_ms"]), flush=True)
    frames3 = check_frames(run3, WIDTH, HEIGHT, "slice 3")
    state3 = run3["state"]
    hist_vals = torch.cat(taa.unpack_f16_pair(state3.gi_history))
    hist_mean = float(hist_vals.abs().mean())
    hist_share = float((state3.gi_history != 0).float().mean())
    print(f"slice 3 GI history after {run3['frames']} frames: mean |value| "
          f"{hist_mean:.4e}, {hist_share:.4f} of words nonzero", flush=True)
    check(hist_share > 0.1 and np.isfinite(hist_mean) and hist_mean > 0.0,
          "the GI history is written (the temporal path ran)")

    # device busy share and time by kernel name over 2 more slice-3 frames
    # under torch.profiler (CUDA activity); the profiler's own host cost is
    # in the window, so the share is a lower bound
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            _, state3 = frame.render_frame(state3, scene3, cams[-1], luts,
                                           1.0 / 60.0, settings3, device=dev)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_kernel = sorted(
        ((e.key, getattr(e, "self_device_time_total", 0.0), e.count)
         for e in prof.key_averages()), key=lambda k: -k[1])
    device_us = sum(t for _, t, _ in by_kernel)
    device_launches = sum(n for _, _, n in by_kernel) / 2
    busy = device_us / window_us if device_us > 0 else None
    print(f"profiler (slice 3): device busy {device_us / 2e3:.2f} ms/frame "
          f"of {window_us / 2e3:.2f} ms wall -> busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'}; "
          f"{device_launches:.0f} device kernels/frame under "
          f"{len(by_kernel)} names", flush=True)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        by_bytes, by_ops = bounds[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": run3["launches"][name],
            "max_abs_err": errors[name], "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms[name]}
        if name == "expand_keys":  # its second use: the atlas's keys
            entry.update(atlas_ms=atlas_a_ms, atlas_plain_ms=atlas_a_plain_ms,
                         atlas_bound_ms=atlas_a_bound)
        kernels.append(entry)
    report["slice3"] = dict(
        passes_ms=run3["pass_ms"], launches=run3["launches"],
        host_syncs_per_frame=run3["host_syncs_per_frame"],
        frames=run3["frames"], pair_budget_scale=scale, sdf_bake_s=bake_s,
        sdf_grid=list(grid), sdf_bricks=n_bricks, sdf_packed_bytes=sdf_bytes,
        coarse_dims=list(c_dims), coarse_factor=c_f, gi_planes=[gh, gw],
        trace_escaped_equal=esc_equal, trace_hit_equal=hit_equal,
        trace_hit_share=hit_share, trace_escaped_share=escaped_share,
        trace_loop_steps=g_stats, history_planes=list(planes_h.shape),
        history_ok_share=ok_share, small_close=close3,
        gi_history_mean_abs=hist_mean, gi_history_nonzero=hist_share,
        busy_share=busy, profiled_device_us_per_frame=device_us / 2,
        device_kernels_per_frame=device_launches,
        profiled_wall_us_per_frame=window_us / 2,
        top_kernels_us_per_frame=[(k, t / 2, n / 2)
                                  for k, t, n in by_kernel[:30]],
        **frames3)
    report.update(kernels=kernels, total_s=time.time() - t_start)
    (OUT / "report.json").write_text(json.dumps(report, indent=1))
    print(f"total {report['total_s']:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
