#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root with one CUDA device visible:

    python3 chip_smoke.py

What it does, in order; any failed check raises and the script exits
non-zero without printing its final line:

 1. prints the card's name and power limit (nvidia-smi) and builds the
    CUDA kernels of plainrenderer_tpu_torch/csrc (nvcc, sm_90a);
 2. renders the bench's procedural atrium (292,672 triangles, untextured)
    at 1920x1080 on the bench camera path with the slice's settings
    (shadows, SDF GI, TAA and bloom off);
 3. holds each kernel against its plain PyTorch version on the card, at
    the shapes of a real frame's intermediates: kernels A (pair keys) and
    C (material lookup) exactly, kernel B (G-buffer) by the CPU tests'
    rule (>= 99.9% equal winners and depth, channels within 1e-4); and the
    whole slice against the CPU plain path on a small scene (3 frames at
    256x128, > 99.9% of pixels within 2 LSB);
 4. times each kernel, its plain version and (kernel C) one PyTorch
    indexing call with CUDA events;
 5. resets the launch counts, renders 3 warm-up and 8 timed frames through
    render_frame with per-pass CUDA events, reads the counts (every kernel
    must have launched at least once per frame) and checks the frames:
    debug_counters [0, 0], image mean in (2, 253) and std > 5, exposure
    finite and > 0;
 6. prints the per-pass times, the kernels line and, last,
    {"ok": true, "device": {...}}.

Everything also goes to chiprun_out/chip_smoke/ as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
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
WARMUP, TIMED = 3, 8
KERNEL_SOURCES = {
    "expand_keys": ("plainrenderer_tpu_torch/csrc/expand_keys.cu",
                    "plainrenderer_tpu/ops/raster.py:406"),
    "gbuffer": ("plainrenderer_tpu_torch/csrc/gbuffer.cu",
                "plainrenderer_tpu/ops/raster.py:1564"),
    "material": ("plainrenderer_tpu_torch/csrc/material.cu",
                 "plainrenderer_tpu/ops/post.py:69"),
}


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


def slice_settings(cfg, width, height):
    return cfg.RenderSettings(
        width=width, height=height,
        shadows=cfg.ShadowSettings(cascade_count=0),
        sdf_trace=cfg.SDFTraceSettings(enabled=False),
        taa=cfg.TAASettings(enabled=False),
        bloom=cfg.BloomSettings(enabled=False))


def bench_camera(frame, cam_mod, t: int, device):
    """bench.py:105-110's flight path."""
    import numpy as np

    ext = cam_mod.extrinsic_from_angles(
        [-9.0 + 0.02 * t, -1.8, 0.3 * np.sin(t * 0.05)],
        pitch_deg=8.0, yaw_deg=10.0 + t * 0.1)
    return frame.camera_arrays(ext.position, ext.forward, ext.right, ext.up,
                               device=device)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "measures the GPU port and has no CPU mode", file=sys.stderr)
        return 2
    from plainrenderer_tpu_torch import config, native
    from plainrenderer_tpu_torch.assets import procedural
    from plainrenderer_tpu_torch.ops import post, raster
    from plainrenderer_tpu_torch.render import frame, scenebuild
    from plainrenderer_tpu_torch.render.state import initial_state
    from plainrenderer_tpu_torch.scene import camera as cam_mod
    from plainrenderer_tpu_torch.utils.timing import PassTimer

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

    t0 = time.time()
    lib_path = native.build()
    native.library()
    report["build_s"] = time.time() - t0
    print(f"build: {report['build_s']:.1f} s -> {lib_path}", flush=True)
    (OUT / "ptxas.log").write_text(
        (lib_path.parent / "ptxas.log").read_text()
        if (lib_path.parent / "ptxas.log").exists() else "cached build\n")

    # --- the bench's scene at full size ---
    t0 = time.time()
    cfg = procedural.AtriumConfig(columns_per_row=6, column_segments=64,
                                  floor_subdiv=64, box_count=12,
                                  box_subdiv=16, banner_count=4)
    rs = scenebuild.build_render_scene(
        procedural.build_atrium_scene(cfg, textured=False))
    check(rs.triangle_count == 292_672, f"triangles {rs.triangle_count}")
    check(rs.material_table.shape[0] == 45, "45 materials")
    settings = slice_settings(config, WIDTH, HEIGHT)
    scene = frame.scene_to_device(rs, device=dev)
    luts = frame.bake_static_luts(settings, device=dev)
    cams = [bench_camera(frame, cam_mod, t, dev)
            for t in range(WARMUP + TIMED)]
    torch.cuda.synchronize()
    report["setup_s"] = time.time() - t0
    print(f"scene: {rs.triangle_count} triangles, {rs.object_count} "
          f"objects; setup {report['setup_s']:.1f} s", flush=True)

    # --- kernels against their plain versions at a real frame's shapes ---
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
    differ = (ids_k != ids_p) | (depth_k != depth_p)
    frac_differ = float(differ.float().mean())
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

    # whole slice, small scene: card (kernels) vs CPU (plain versions)
    small = dataclasses.replace(slice_settings(config, 256, 128),
                                exposure_adaption_speed=1000.0)
    rs_s = scenebuild.build_render_scene(procedural.build_atrium_scene(
        procedural.AtriumConfig(columns_per_row=2, floor_subdiv=2,
                                box_count=3, box_subdiv=1,
                                column_segments=8), textured=False))
    images = []
    for d in ("cuda", "cpu"):
        sc = frame.scene_to_device(rs_s, device=d)
        lt = {k: v.to(d) for k, v in luts.items()}
        st = initial_state(256, 128, device=d)
        ext = cam_mod.extrinsic_from_angles([0.0, -1.7, 0.0], pitch_deg=5.0,
                                            yaw_deg=20.0)
        cm = frame.camera_arrays(ext.position, ext.forward, ext.right,
                                 ext.up, device=d)
        for _ in range(3):
            img, st = frame.render_frame(st, sc, cm, lt, 0.016, small,
                                         device=d)
        images.append(img.cpu().numpy().astype(np.int32))
    close = float((np.abs(images[0] - images[1]) <= 2).mean())
    print(f"small slice card vs CPU plain: {close:.5f} of pixels within "
          "2 LSB (limit > 0.999)", flush=True)
    check(close > 0.999, "small-scene image card vs CPU")

    # --- kernel timings (outside the main-path count window) ---
    n_pix = mv.n_tiles_y * mv.sub * raster.TILE_H * mv.n_tiles_x * \
        raster.TILE_W
    ms = {
        "expand_keys": cuda_ms(lambda: raster.expand_keys(ki), 50),
        "gbuffer": cuda_ms(lambda: raster.rasterize_gbuffer(
            pe, pa, pairs, mv.n_tiles_y, mv.n_tiles_x, sub=mv.sub,
            row_skip=True), 20),
        "material": cuda_ms(
            lambda: post.material_kernel(table, mat_id, valid), 50),
    }
    plain_ms = {
        "expand_keys": cuda_ms(lambda: raster.expand_keys_plain(ki), 10),
        "gbuffer": cuda_ms(lambda: raster.gbuffer_plain(
            pe, pa, pairs.tile_start, pairs.tile_count, mv.n_tiles_y,
            mv.n_tiles_x, mv.sub, True), 2),
        "material": cuda_ms(
            lambda: post.material_plain(table, mat_id, valid), 20),
    }
    # yardstick for kernel C: one PyTorch gather of the same table rows
    # (pixel-major output; the id clip and valid select are folded into a
    # precomputed index into a table with a zero row 128)
    table_rows = torch.cat([table.T, torch.zeros(1, table.shape[0],
                                                 device=dev)])
    gather_idx = torch.where(valid, mat_id.long().clamp(0, 127),
                             128).reshape(-1)
    library_ms = {"expand_keys": None, "gbuffer": None,
                  "material": cuda_ms(
                      lambda: table_rows.index_select(0, gather_idx), 50)}

    # bounds: bytes each input read once and each output written once;
    # operations counted on this frame's data
    t_count, budget = ki.tpv, ki.budget
    a_bytes = 4 * (3 * t_count + 2 * budget)
    a_ops = live_pairs * (3 * max(1, int(np.ceil(np.log2(t_count)))) + 20)
    n_pairs = pe.shape[1]
    b_bytes = 4 * (pe.shape[0] + pa.shape[0]) * n_pairs \
        + 8 * pairs.tile_start.shape[0] + n_pix * 4 * (2 + 13)
    counts = pairs.tile_count.long()
    seg = torch.repeat_interleave(
        torch.arange(counts.numel(), device=dev), counts)
    first = torch.repeat_interleave(pairs.tile_start.long(), counts)
    rank = torch.arange(seg.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    stream = first + rank
    fy0, fy1 = pe[3, stream], pe[7, stream]
    row0 = (seg // mv.n_tiles_x * mv.sub).float()
    sub_rows = (torch.minimum(fy1, row0 + mv.sub - 1)
                - torch.maximum(fy0, row0) + 1).clamp(min=0)
    evaluated = float(sub_rows.sum()) * raster.PX_PER_TILE
    # 4 planes x (mul + add + add) per evaluated (pair, pixel) + about 80
    # flops of attribute evaluation per covered pixel
    b_ops = 12 * evaluated + 80 * float((vis_k >= 0).sum())
    c_bytes = n_pix * (4 + 1 + 4 * table.shape[0]) + table.numel() * 4
    bounds = {
        "expand_keys": (a_bytes / HBM_BYTES_PER_S,
                        a_ops / INT32_OPS_PER_S),
        "gbuffer": (b_bytes / HBM_BYTES_PER_S, b_ops / FP32_OPS_PER_S),
        "material": (c_bytes / HBM_BYTES_PER_S, 0.0),
    }
    errors = {"expand_keys": err_a, "gbuffer": err_b, "material": err_c}

    # --- the main path: counts reset, 3 warm-up + 8 timed frames ---
    native.reset_launch_counts()
    state = initial_state(WIDTH, HEIGHT, device=dev)
    dt = 1.0 / 60.0
    timers, counters, images = [], [], []
    torch.cuda.synchronize()
    t_wall = None
    for i in range(WARMUP + TIMED):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_wall = time.perf_counter()
        timer = PassTimer() if i >= WARMUP else None
        image, state = frame.render_frame(state, scene, cams[i], luts, dt,
                                          settings, device=dev, timer=timer)
        counters.append(state.debug_counters)
        if timer is not None:
            timers.append(timer)
            images.append(image)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t_wall) * 1e3 / TIMED
    launches = native.launch_counts()
    n_frames = WARMUP + TIMED
    print(f"launches over {n_frames} frames: {launches}", flush=True)
    for name in KERNEL_SOURCES:
        check(launches[name] >= n_frames,
              f"kernel {name} launched every frame")

    passes = [t.intervals() for t in timers]
    names = sorted(passes[0])
    pass_ms = {n: {"mean": float(np.mean([p[n] for p in passes])),
                   "min": float(np.min([p[n] for p in passes]))}
               for n in names}
    pass_ms["host_wall_per_frame"] = {"mean": wall_ms}
    print("passes_ms " + json.dumps(pass_ms), flush=True)

    counters = torch.stack(counters).cpu().numpy()
    check((counters == 0).all(), f"debug_counters all zero: {counters}")
    last = images[-1].float()
    mean, std = float(last.mean()), float(last.std())
    exposure = float(state.exposure)
    print(f"image {tuple(images[-1].shape)} mean {mean:.2f} std {std:.2f}; "
          f"exposure {exposure:.4e}; debug_counters {counters[-1].tolist()}",
          flush=True)
    check(tuple(images[-1].shape) == (HEIGHT, WIDTH, 3), "image shape")
    check(2.0 < mean < 253.0 and std > 5.0, "image not empty or saturated")
    check(np.isfinite(exposure) and exposure > 0.0, "exposure")
    check(bool(torch.isfinite(state.prev_color).all()), "finite HDR")

    # device busy share and time by kernel name over 2 more frames under
    # torch.profiler (CUDA activity); the profiler's own host cost is in
    # the window, so the share is a lower bound
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            _, state = frame.render_frame(state, scene, cams[-1], luts, dt,
                                          settings, device=dev)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_kernel = sorted(
        ((e.key, getattr(e, "self_device_time_total", 0.0), e.count)
         for e in prof.key_averages()), key=lambda k: -k[1])
    device_us = sum(t for _, t, _ in by_kernel)
    device_launches = sum(n for _, _, n in by_kernel) / 2
    busy = device_us / window_us if device_us > 0 else None
    print(f"profiler: device busy {device_us / 2e3:.2f} ms/frame of "
          f"{window_us / 2e3:.2f} ms wall -> busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'}; "
          f"{device_launches:.0f} device kernels/frame under "
          f"{len(by_kernel)} names", flush=True)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        by_bytes, by_ops = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors[name], "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms[name]})
    report.update(busy_share=busy, profiled_device_us_per_frame=device_us / 2,
                  device_kernels_per_frame=device_launches,
                  profiled_wall_us_per_frame=window_us / 2,
                  top_kernels_us_per_frame=[(k, t / 2, n / 2)
                                            for k, t, n in by_kernel[:25]],
                  pairs_per_bin={
                      "max": int(pairs.tile_count.max()),
                      "mean": float(pairs.tile_count.float().mean()),
                      "nonzero_bins": int((pairs.tile_count > 0).sum())},
                  passes_ms=pass_ms, kernels=kernels, launches=launches,
                  frames=n_frames, image_mean=mean, image_std=std,
                  exposure=exposure, gbuffer_pixels_differ=frac_differ,
                  small_slice_close=close, live_pairs=live_pairs,
                  pair_budget=budget, evaluated_pair_pixels=evaluated)
    (OUT / "report.json").write_text(json.dumps(report, indent=1))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
