#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Run from the repository root with one CUDA device visible:

    python3 chip_smoke.py

It prints the card's name and power limit (nvidia-smi), builds the CUDA
kernels of plainrenderer_tpu_torch/csrc (nvcc, sm_90a, one process per
source, all started together) and walks SLICES, one row per slice of the
port at 1920x1080 on the bench camera path (uploaded once, indexed on
the device: camera-path mode): 1 the untextured atrium
(kernels A, B, C); 2 the textured atrium with sun shadows (D, E, F, A's
multi-view keys; it picks pair_budget_scale); 3 with SDF GI (G, H); 4
the default RenderSettings() with TAA, bloom and fog (I; the golden
scene on the card against tests/golden_frame.npz and the CPU); 5
bench.py's own scene, the textured atrium with its 4 alpha-tested
banners (J, K, L; M in a phase of its own, build_pairs(carry_table=...)
on the frame's main-view setup; A-I checked and timed again on this
scene's inputs; after its run the same frames run as a flight,
render_flight's CUDA graph replays, bit-equal to them, with the replays'
frame time, capture time, launches and busy share); 6 the same scene with its 12 boxes moving in the raster
and the SDF and texture_filter 2 (the variants of B and L with the
previous-NDC channels, D's trilinear and anisotropic branches, M at 56
rows; the previous NDC, the recomposited SDF). Each row
holds its kernels to their plain PyTorch versions on a real frame's
inputs (the rule is printed with each result), a small scene on the card
to the CPU plain path (> 99.9% of pixels within 2 LSB), times each
kernel, its plain version and its PyTorch yardstick on the device
(cuda_ms: CUDA events around back-to-back calls queued behind
torch.cuda._sleep, with the host's enqueue time per call beside it and
the check that the enqueue ended inside the sleep) with
its bound from this run's inputs (the kernels line names that row,
timed_on, and the run its launches come from, launches_on), and drives
warm-up + timed frames with
the launch counts reset just before and read just after: its kernels
launched as expected per frame, the others never, no host sync in a
timed frame, debug_counters [0, 0], a plausible image. A failed check
exits non-zero before the last line, {"ok": true, "device": {...}},
which follows the per-pass times, the card line and the kernels line.
The report goes to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from plainrenderer_tpu_torch import config, native
from plainrenderer_tpu_torch.assets import procedural
from plainrenderer_tpu_torch.assets.textures import MAX_MIPS
from plainrenderer_tpu_torch.ops import (color_packing, post, raster,
                                         sdf_scene, sdfgi, shade, shadow,
                                         taa, texture)
from plainrenderer_tpu_torch.render import frame, scenebuild
from plainrenderer_tpu_torch.render.state import initial_state
from plainrenderer_tpu_torch.scene import camera as cam_mod
from plainrenderer_tpu_torch.utils import mathutils
from plainrenderer_tpu_torch.utils.timing import PassTimer

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): HBM3
# bandwidth and non-tensor FP32. INT32: Hopper issues 64 INT32 ops per SM
# per clock, half its 128 FP32 lanes, so half the FP32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
L2_BYTES = 50e6

WIDTH, HEIGHT = 1920, 1080
# kernel -> (source under plainrenderer_tpu_torch/csrc/, the TPU kernel it
# replaces under plainrenderer_tpu/ops/)
KERNEL_SOURCES = {
    "expand_keys": ("expand_keys.cu", "raster.py:406"),
    "gbuffer": ("gbuffer.cu", "raster.py:1564"),
    "material": ("material.cu", "post.py:69"),
    "texture": ("texture.cu", "texture.py:47"),
    "depth": ("depth.cu", "raster.py:1465"),
    "shadow": ("shadow.cu", "shadow.py:167"),
    "sdfgi_trace": ("sdfgi.cu", "sdfgi.py:112"),
    "packed_planes": ("packed_planes.cu", "taa.py:277"),
    "history_taps": ("history_taps.cu", "taa.py:134"),
    "depth_alpha": ("depth_alpha.cu", "raster.py:1474"),  # and :1483 (_acc)
    "winner_alpha": ("gbuffer_alpha.cu", "raster.py:1743"),
    "attr_resolve": ("gbuffer_alpha.cu", "raster.py:1755"),
    "expand_rows": ("expand_rows.cu", "raster.py:606"),
}
# operations of one step of kernel G's loops and of a ray's fixed work,
# counted from csrc/sdfgi.cu (float and integer ops alike): the fine step
# (position, window coords, clamp, inside/excess, brick address, s8
# decode, hit/exit tests, step), a shadow step, a coarse step, and per
# ray the setup, refinement, albedo, pow, sky mapping and SH encode
G_FINE_STEP_OPS, G_SHADOW_STEP_OPS, G_COARSE_STEP_OPS = 60, 45, 35
G_RAY_OPS = 150
# the flight phase's measured replays: between CUDA events, and under the
# profiler (flight_phase)
FLIGHT_REPLAYS, FLIGHT_PROFILED = 8, 3
# rows of a pair's table that the raster kernels' bounds count as read:
# B and E 12 plane rows and the row extents (rows 3, 7); J and K the 22
# rows of their per-pixel step (csrc/common.cuh, PLAIN_ROWS_ALPHA) and
# the row extents
N_STAGED, N_STAGED_ALPHA = 14, 24
SMALL_ATRIUM = dict(columns_per_row=2, floor_subdiv=2, box_count=3,
                    box_subdiv=1, column_segments=8)
# tests/test_frame.py:312-314's banner atrium and its camera (:320)
SMALL_BANNERS = dict(columns_per_row=2, floor_subdiv=2, box_count=0,
                     box_subdiv=1, column_segments=8, banner_count=2)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, types and bits (a float's sign of zero and NaN
    payloads too)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(bits[t.element_size()]) for t in (a, b))
    return bool(torch.equal(a, b))


_SLEEP_CYCLES_PER_MS = []


def sleep_cycles_per_ms() -> float:
    """SM clock cycles per device ms of torch.cuda._sleep, measured once."""
    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def cuda_ms(fn, reps: int, strict: bool = True) -> dict:
    """Device time of fn: reps back-to-back calls between two CUDA events,
    queued behind torch.cuda._sleep on the same stream. The sleep is sized
    so that the host has enqueued every call and the end event before the
    card wakes up, so the card runs the calls with no gap that the host's
    enqueue makes. Returns ms (device ms per call), host_us (the host's
    enqueue time per call, taken while the card sleeps), reps, sleep_ms
    (the sleep's device time between its events) and inside (the enqueue
    ended within it). A failed attempt halves reps (the launch queue holds
    ~1,000 entries; a full one blocks the host) and doubles the sleep.
    strict raises after 6 attempts; the plain versions (strict False,
    some read values back to the host) take one attempt and report
    inside."""
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    one_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = min(max(2.0, 3.0 * one_ms * reps), 1000.0 if strict else 100.0)
    pre, start, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    for attempt in range(6 if strict else 1):
        if attempt:
            reps = max(1, reps // 2)
            sleep_ms = min(2.0 * max(sleep_ms, host_ms), 4000.0)
        cycles = int(sleep_ms * sleep_cycles_per_ms())
        t0 = time.perf_counter()
        pre.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        slept = pre.elapsed_time(start)
        if host_ms < slept:
            break
    inside = host_ms < slept
    check(inside or not strict, "the timed calls were enqueued within the "
          f"sleep ({host_ms:.3f} ms of enqueue, {slept:.3f} ms slept)")
    return dict(ms=start.elapsed_time(end) / reps,
                host_us=host_ms * 1e3 / reps, reps=reps, sleep_ms=slept,
                inside=inside)


def slice_settings(n: int, width: int, height: int, **shadows):
    """Slice n's RenderSettings: 4 and 5 the defaults (TAA tech 4, bloom,
    fog, GI, 3 sun cascades of 2048^2); 6 with anisotropic texture
    filtering (texture_filter 2); 3 without TAA, bloom and fog; 2 also
    without GI; 1 also without shadows."""
    off = dict(enabled=False)
    drop = dict(taa=config.TAASettings(**off),
                bloom=config.BloomSettings(**off),
                volumetrics=config.VolumetricsSettings(**off)) if n <= 3 else {}
    if n >= 6:
        drop["shading"] = config.ShadingConfig(texture_filter=2)
    if n <= 2:
        drop["sdf_trace"] = config.SDFTraceSettings(**off)
    if n <= 1:
        shadows = dict(cascade_count=0)
    return config.RenderSettings(width=width, height=height,
                                 shadows=config.ShadowSettings(**shadows),
                                 **drop)


def pair_rows(pair_edges, pairs, n_tiles_x: int, sub: int,
              row_skip: bool = True):
    """The live pairs of these pair lists: their bin, their column in the
    stream, and the first and count of their bin's 16-px fine rows inside
    the pair's [fy0, fy1] (pair_edges rows 3 and 7; all sub rows of the
    bin without row_skip)."""
    dev = pair_edges.device
    counts = pairs.tile_count.long()
    seg = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                  counts)
    rank = torch.arange(seg.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    stream = torch.repeat_interleave(pairs.tile_start.long(), counts) + rank
    row0 = (seg // n_tiles_x * sub).float()
    if not row_skip:
        return seg, stream, row0.long(), torch.full_like(seg, sub)
    lo = torch.maximum(pair_edges[3, stream], row0)
    n_rows = (torch.minimum(pair_edges[7, stream], row0 + sub - 1) - lo
              + 1).clamp(min=0).long()
    return seg, stream, lo.long(), n_rows


def evaluated_pair_pixels(pair_edges, pairs, n_tiles_x: int, sub: int):
    """(pair, pixel) plane evaluations a row-skipping raster kernel does
    when it evaluates each pair on every pixel of its rows (pair_rows),
    2048 pixels each."""
    return float(pair_rows(pair_edges, pairs, n_tiles_x, sub)[3].sum()) \
        * 2048


# block sizes (w, h) whose work the raster bounds compare; each tiles a
# 16 x 128 fine row. Kernels E and B test 16 x 16 blocks.
BLOCK_SIZES = ((8, 8), (16, 8), (16, 16), (32, 16), (64, 16))


def block_tests(pair_edges, pairs, n_tiles_x: int, sub: int, bw: int,
                bh: int, z: bool = False, row_skip: bool = True):
    """(tests, pixels) of a raster that tests each pair against the bw x
    bh blocks of its rows (pair_rows) with the exact corner test
    (raster.block_may_cover; with z, kernel B's z range test too) and
    evaluates the pixels of the blocks that pass: the corner tests made
    and the pixels of the passing blocks, on these pair lists."""
    dev = pair_edges.device
    seg, stream, lo, n_rows = pair_rows(pair_edges, pairs, n_tiles_x, sub,
                                        row_skip)
    edges = pair_edges[[0, 1, 2, 4, 5, 6, 8, 9, 10]]
    bx = torch.arange(0, raster.TILE_W, bw, device=dev)
    by = torch.arange(0, raster.TILE_H, bh, device=dev)
    tests = passing = 0
    step = 1 << 15
    for c0 in range(0, stream.numel(), step):
        nr = n_rows[c0:c0 + step]
        pr = torch.repeat_interleave(torch.arange(nr.numel(), device=dev),
                                     nr)
        fine = lo[c0:c0 + step][pr] + torch.arange(
            pr.numel(), device=dev) - torch.repeat_interleave(
                torch.cumsum(nr, 0) - nr, nr)
        x0 = (seg[c0:c0 + step][pr] % n_tiles_x * raster.TILE_W)[
            :, None, None] + bx[None, None]
        y0 = (fine * raster.TILE_H)[:, None, None] + by[None, :, None]
        cols = stream[c0:c0 + step][pr]
        zp = pair_edges[12:15, cols][..., None, None] if z else None
        may = raster.block_may_cover(
            edges[:, cols].reshape(3, 3, -1, 1, 1), x0, y0, bw, bh, zp)
        tests += may.numel()
        passing += int(may.sum()) * bw * bh
    return tests, passing


def block_work(pair_edges, pairs, n_tiles_x: int, sub: int,
               z: bool = False):
    """block_tests at each of BLOCK_SIZES, and the size whose tests plus
    pixels are fewest: a raster bound that counts 12 ops per test and per
    pixel at that size is a floor for a design at any of these sizes."""
    sizes = {f"{bw}x{bh}": block_tests(pair_edges, pairs, n_tiles_x, sub,
                                       bw, bh, z)
             for bw, bh in BLOCK_SIZES}
    return sizes, min(sizes, key=lambda k: sum(sizes[k]))


def stream_counts(pair_edges, pairs, n_tiles_x: int, sub: int,
                  row_skip: bool, z: bool) -> dict:
    """A pair stream's work as kernels J (z False, no row skip on the
    atlas) and K (z True, row_skip) see it: its pairs, the bins holding
    any, the median and largest pairs of such a bin, and the corner tests
    and pixels of the passing 16 x 16 blocks (block_tests)."""
    counts = pairs.tile_count
    live = counts[counts > 0].float()
    tests, pixels = block_tests(pair_edges, pairs, n_tiles_x, sub, 16, 16,
                                z, row_skip)
    return dict(pairs=int(counts.sum()), bins=counts.numel(),
                bins_with_pairs=live.numel(),
                p50_pairs_per_bin=float(live.quantile(0.5))
                if live.numel() else 0.0,
                max_pairs_per_bin=int(counts.max()),
                block_tests_16x16=tests, block_pixels_16x16=pixels)


class Ctx:
    """What the rows share: device, cameras, LUTs, scenes and the
    per-kernel results the kernels line is made of."""

    def __init__(self, dev):
        self.dev = dev
        self.results, self.extra = {}, {}
        self.scenes, self.scale, self.report = {}, 1.0, {}
        self.path = ""
        self.earlier, self.variants = {}, {}

    def kernel(self, name, fn, reps, plain, plain_reps, bound, err,
               library=None, variant=None):
        """Time kernel `name`, its plain version and its PyTorch yardstick
        (cuda_ms: device time, host enqueue us per call, the check that the
        enqueue ended within the sleep); keep its bound (bytes s,
        operations s), its time as a multiple of the bound (x_bound), its
        error and the row whose inputs timed it (self.path). The L2 note
        compares the bytes a call touches (the bound's bytes) with the 50
        MB L2: back-to-back calls on inputs that fit read them warm. A
        kernel timed again keeps its earlier time in `earlier`; a variant
        (another branch of the same kernel) goes into `variants` beside the
        default one."""
        t, tp = cuda_ms(fn, reps), cuda_ms(plain, plain_reps, strict=False)
        tl = library and cuda_ms(library, 50)
        touched = bound[0] * HBM_BYTES_PER_S
        result = dict(
            timed_on=self.path, ms=t["ms"], host_us=t["host_us"],
            enqueue_inside_sleep=t["inside"], reps=t["reps"],
            sleep_ms=t["sleep_ms"], plain_ms=tp["ms"],
            plain_host_us=tp["host_us"],
            plain_enqueue_inside_sleep=tp["inside"],
            library_ms=tl and tl["ms"], library_host_us=tl and tl["host_us"],
            max_abs_err=err, bound_ms=max(bound) * 1e3,
            bound_by="bytes" if bound[0] >= bound[1] else "operations",
            x_bound=t["ms"] / (max(bound) * 1e3),
            l2=f"{touched / 1e6:.1f} MB touched per call: "
               + ("fits in the 50 MB L2, read warm" if touched < L2_BYTES
                  else "exceeds the 50 MB L2"))
        lib = "none" if tl is None else f"{tl['ms']:.4f} ms"
        print(f"{name}{'' if variant is None else f' ({variant})'}: "
              f"{t['ms']:.4f} ms device ({t['host_us']:.1f} us host enqueue "
              f"per call, inside the sleep: {t['inside']}), bound "
              f"{result['bound_ms']:.4f} ms ({result['bound_by']}), "
              f"{result['x_bound']:.2f}x the bound, plain "
              f"{tp['ms']:.3f} ms, library {lib}; {result['l2']}",
              flush=True)
        if variant is not None:
            self.variants.setdefault(name, {})[variant] = result
            return
        if name in self.results:
            old = self.results[name]
            self.earlier.setdefault(name, []).append(
                {k: old[k] for k in ("timed_on", "ms", "host_us",
                                     "plain_ms")})
        self.results[name] = result


def drive(ctx, frames, settings, warmup: int, timed: int):
    """One main-path run over the per-frame scenes `frames` (one per
    camera): launch counts reset just before, read just after;
    per-pass CUDA events on the timed frames, which also run under
    torch.cuda's sync debug mode to count the host synchronisations the
    frame makes (none expected). Every frame gets the whole camera path
    (ctx.cam_path, camera-path mode: render_frame indexes it on the
    device), as bench.py drives its frames."""
    state = initial_state(settings.width, settings.height, device=ctx.dev)
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
            image, state = frame.render_frame(
                state, frames[i], ctx.cam_path, ctx.luts, 1.0 / 60.0,
                settings, device=ctx.dev, timer=timer)
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


def check_run(run: dict, row, what: str) -> dict:
    """The row's launch counts, no host sync, debug_counters [0, 0] and a
    plausible last frame."""
    n = run["frames"]
    print(f"{what}: launches over {n} frames: {run['launches']}; host "
          f"syncs per timed frame {run['host_syncs_per_frame']}", flush=True)
    check(run["host_syncs_per_frame"] == 0,
          f"{what}: the frame never waits for the device")
    for name, k in row.per_frame.items():
        check(run["launches"][name] >= k * n,
              f"{what}: kernel {name} launched {k}x per frame")
    for name in set(KERNEL_SOURCES) - set(row.per_frame):
        check(run["launches"][name] == 0, f"{what} runs no {name} kernel")
    print(f"{what} passes_ms " + json.dumps(run["pass_ms"]), flush=True)
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
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3), f"{what}: image shape")
    check(2.0 < mean < 253.0 and std > 5.0,
          f"{what}: image not empty or saturated")
    check(np.isfinite(exposure) and exposure > 0.0, f"{what}: exposure")
    check(bool(torch.isfinite(state.prev_color).all()), f"{what}: finite HDR")
    found = dict(passes_ms=run["pass_ms"], launches=run["launches"],
                 host_syncs_per_frame=run["host_syncs_per_frame"],
                 frames=n, image_mean=mean, image_std=std, exposure=exposure)
    for field, decode in row.histories.items():  # the temporal paths ran
        words = getattr(state, field)
        share = float((words != 0).float().mean())
        mean_abs = float(torch.cat(list(decode(words))).abs().mean())
        print(f"{what} {field} after {n} frames: mean |value| "
              f"{mean_abs:.4e}, {share:.4f} of words nonzero", flush=True)
        check(share > 0.1 and np.isfinite(mean_abs) and mean_abs > 0.0,
              f"{what}: {field} is written")
        found.update({field + "_mean_abs": mean_abs,
                      field + "_nonzero": share})
    return found


def small_images(ctx, settings, textured: bool, gi: bool = False,
                 moving: bool = False, banners: bool = False,
                 dynamic: bool = False):
    """3 frames of the small atrium at 256x128 on the card (kernels) and on
    the CPU (plain versions): the two u8 images. With gi, the scene SDF is
    baked on the card at 16^3 per mesh and attached on both sides; with
    moving, the camera moves a little every frame (a static camera puts
    the GI history window's edge test on exact ties, where rounding noise
    in the motion decides); with banners, the small banner atrium from the
    JAX test's camera; with dynamic, its first box moves (box_motions) in
    the raster and, with gi, in the SDF."""
    scene_data = procedural.build_atrium_scene(
        procedural.AtriumConfig(**(SMALL_BANNERS if banners
                                   else SMALL_ATRIUM)), textured=textured)
    rs = scenebuild.build_render_scene(scene_data)
    boxes = box_objects(SMALL_ATRIUM)[:1] if dynamic else ()
    gsdf = sdf_scene.build_scene_sdf(
        rs, scene_data, bake_resolution_cap=16, device=ctx.dev,
        dynamic_objects=boxes) if gi else None
    images = []
    for d in (ctx.dev, "cpu"):
        sc = frame.scene_to_device(rs, device=d)
        if gi and dynamic:
            sc = frame.attach_dynamic_sdf(
                frame.attach_global_sdf(sc, gsdf[0]), gsdf[1])
        elif gi:
            sc = frame.attach_global_sdf(sc, gsdf)
        frames = moving_frames(sc, box_motions(
            rs.object_matrices, boxes, 3, d)) if dynamic else [sc] * 3
        lt = {k: v.to(d) for k, v in ctx.luts.items()}
        st = initial_state(256, 128, device=d)
        for i in range(3):
            k = i if moving else 0
            ext = cam_mod.extrinsic_from_angles(
                [0.0, -1.7, -4.0], pitch_deg=0.0, yaw_deg=0.0) if banners \
                else cam_mod.extrinsic_from_angles(
                    [0.05 * k, -1.7, 0.02 * k], pitch_deg=5.0,
                    yaw_deg=20.0 + 0.3 * k)
            cm = frame.camera_arrays(ext.position, ext.forward, ext.right,
                                     ext.up, device=d)
            img, st = frame.render_frame(st, frames[i], cm, lt, 0.016,
                                         settings, device=d)
        images.append(img.cpu().numpy().astype(np.int32))
        if textured:
            check((st.debug_counters.cpu().numpy() == 0).all(),
                  f"small scene debug_counters on {d}")
    return images


def golden_close(a, b) -> float:
    """The golden rule's share: u8 pixels within 2 LSB (test_golden.py)."""
    return float((np.abs(a.astype(np.int32) - b.astype(np.int32)) <= 2)
                 .mean())


def small_card_vs_cpu(ctx, n: int, what: str = "", **kw) -> float:
    """small_images of a row's settings at 256x128 with 256^2 shadow maps
    and exposure_adaption_speed=1000, card vs CPU by the golden rule."""
    settings = dataclasses.replace(slice_settings(n, 256, 128,
                                                  resolution=256),
                                   exposure_adaption_speed=1000.0)
    close = golden_close(*small_images(ctx, settings, **kw))
    what = what or f"small slice-{n} scene"
    print(f"{what} card vs CPU plain: {close:.5f} of pixels within 2 LSB "
          "(limit > 0.999)", flush=True)
    check(close > 0.999, f"{what} card vs CPU")
    return close


# ------------------------------- scenes -------------------------------

# bench.py:66-76's atrium; banner_count=4 is bench.py's own scene
BENCH_ATRIUM = dict(columns_per_row=6, column_segments=64, floor_subdiv=64,
                    box_count=12, box_subdiv=16, banner_count=4)


def atrium_scene(ctx, name: str, textured: bool, banners: int):
    """The bench's atrium: untextured with its 4 banners (slice 1),
    textured without them (slices 2-4), or textured with them (slice 5,
    bench.py's own scene: 256 alpha-tested triangles)."""
    t0 = time.time()
    scene_data = procedural.build_atrium_scene(procedural.AtriumConfig(
        **dict(BENCH_ATRIUM, banner_count=banners)), textured=textured)
    rs = scenebuild.build_render_scene(scene_data)
    n_tex = rs.tex_info.shape[0] // MAX_MIPS if textured else 0
    n_alpha = 0 if rs.alpha_masks is None else int(
        (rs.tri_alpha_slot[:rs.triangle_count] > 0).sum())
    counts = (rs.triangle_count, rs.material_table.shape[0], n_alpha)
    want = {(False, 4): (292_672, 45, 0), (True, 0): (292_416, 41, 0),
            (True, 4): (292_672, 45, 256)}[textured, banners]
    check(counts == want, f"{name}: triangles, materials, alpha-tested "
          f"triangles {counts}, want {want}")
    scene = frame.scene_to_device(rs, device=ctx.dev)
    torch.cuda.synchronize()
    print(f"{name} scene: {rs.triangle_count} triangles ({n_alpha} "
          f"alpha-tested), {rs.object_count} objects, {n_tex} textures, "
          f"{rs.tex_word0.shape[0] if textured else 0} bricks; setup "
          f"{time.time() - t0:.1f} s", flush=True)
    ctx.scenes[("source", name)] = (rs, scene_data)
    return scene


def sdf_atrium_scene(ctx, base: str, key: str):
    """The base scene with its scene SDF baked on the card at
    bake_resolution_cap=32 (bench.py:93-95)."""
    if base not in ctx.scenes:
        ctx.scenes[base] = SCENES[base](ctx)
    rs, scene_data = ctx.scenes[("source", base)]
    t0 = time.time()
    gsdf = sdf_scene.build_scene_sdf(rs, scene_data,
                                     bake_resolution_cap=32, device=ctx.dev)
    torch.cuda.synchronize()
    bake_s = time.time() - t0
    scene = frame.attach_global_sdf(ctx.scenes[base], gsdf)
    grid = scene["sdf_grid"]
    n_bricks = scene["sdf_volume"].shape[0]
    sdf_bytes = scene["sdf_volume"].nbytes + scene["sdf_albedo"].nbytes
    c_dims, c_f = scene["sdf_coarse"][2:]
    print(f"{base} scene SDF: baked on the card in {bake_s:.1f} s; grid "
          f"{gsdf.volume.shape} at {gsdf.voxel_size} m -> padded {grid}, "
          f"{n_bricks} bricks, {sdf_bytes / 1e6:.2f} MB packed; coarse "
          f"{c_dims} (factor {c_f})", flush=True)
    ctx.extra[key] = dict(sdf_bake_s=bake_s, sdf_grid=list(grid),
                          sdf_bricks=n_bricks, sdf_packed_bytes=sdf_bytes,
                          coarse_dims=list(c_dims), coarse_factor=c_f)
    return scene


SCENES = {"untextured": lambda ctx: atrium_scene(ctx, "untextured", False, 4),
          "textured": lambda ctx: atrium_scene(ctx, "textured", True, 0),
          "sdf": lambda ctx: sdf_atrium_scene(ctx, "textured", "sdf"),
          "banners": lambda ctx: atrium_scene(ctx, "banners", True, 4),
          "bench": lambda ctx: sdf_atrium_scene(ctx, "banners", "sdf_bench"),
          "bench_dynamic": lambda ctx: dynamic_atrium_scene(ctx)}


# --------------- kernel checks and timings, shared by rows ---------------

def texture_kwargs(settings) -> dict:
    """Kernel D's keywords as the frame passes them (frame.py:548-558)."""
    taa_bias = settings.taa.enabled and settings.taa.use_mip_bias
    return dict(n_mips=MAX_MIPS, mip_bias=-1.0 if taa_bias else 0.0,
                trilinear=settings.shading.texture_filter >= 1,
                aniso=settings.shading.texture_filter >= 2,
                two_mat=settings.shading.texture_two_mat)


def time_keys(ctx, ki=None, bound=None, atlas_ki=None, atlas_bound=None):
    """Kernel A on a main-view stream and (given) on the atlas's."""
    if ki is not None:
        ctx.kernel("expand_keys", lambda: raster.expand_keys(ki), 50,
                   lambda: raster.expand_keys_plain(ki), 10, bound, 0.0)
    if atlas_ki is not None:
        t = cuda_ms(lambda: raster.expand_keys(atlas_ki), 50)
        ctx.extra["atlas_keys"] = dict(
            atlas_ms=t["ms"], atlas_host_us=t["host_us"],
            atlas_enqueue_inside_sleep=t["inside"],
            atlas_plain_ms=cuda_ms(
                lambda: raster.expand_keys_plain(atlas_ki), 10,
                strict=False)["ms"],
            atlas_bound_ms=max(atlas_bound) * 1e3,
            atlas_timed_on=ctx.path)


def winner_slots(vis, pairs, n_tiles_x: int, sub: int):
    """The pair slots that won the covered pixels (vis decoded against each
    bin's group-aligned segment base, as winner_triangle_ids does)."""
    h, w = vis.shape
    ty = torch.arange(h, device=vis.device) // (raster.TILE_H * sub)
    tx = torch.arange(w, device=vis.device) // raster.TILE_W
    base = pairs.tile_start[ty[:, None] * n_tiles_x + tx[None, :]] \
        // raster.GROUP * raster.GROUP
    return (base + vis)[vis >= 0]


def check_and_time_b(ctx, mv, pairs, pe, pa, what="kernel B",
                     variant=None):
    """Kernel B on one opaque stream against its plain version (the raster
    rule: <= 1e-3 of pixels differ in winner or depth, channels within
    1e-4 where the winners agree), then timed with its bound: it writes
    depth, vis and every channel and reads the pair tables; 12 rounded
    ops per corner test of a (pair, block) in the pair's rows and per
    pixel of the blocks that pass the edge and z tests, at the block size
    that needs the fewest (block_work), + ~80 flops per covered pixel (the
    PR 6 design's count, 12 per pixel of the pair's rows, kept beside
    it). It
    reads the staged edge rows of each live pair, the attribute rows of
    each distinct winning pair slot, and the segment tables. Returns
    (pixels differing, max |err|, covered share, evaluated)."""
    gb_args = (pe, pa, pairs.tile_start, pairs.tile_count, mv.n_tiles_y,
               mv.n_tiles_x, mv.sub, True)
    depth_k, vis_k, gbuf_k = raster.rasterize_gbuffer(
        pe, pa, pairs, mv.n_tiles_y, mv.n_tiles_x, sub=mv.sub, row_skip=True)
    depth_p, vis_p, gbuf_p = raster.gbuffer_plain(*gb_args)
    ids_k = raster.winner_triangle_ids(vis_k, pairs, mv.n_tiles_x, mv.sub)
    ids_p = raster.winner_triangle_ids(vis_p, pairs, mv.n_tiles_x, mv.sub)
    frac_differ = float(((ids_k != ids_p) | (depth_k != depth_p))
                        .float().mean())
    both = (ids_k >= 0) & (ids_k == ids_p)
    err_b = float((gbuf_k - gbuf_p).abs()[:, both].max())
    covered = float((vis_k >= 0).float().mean())
    n_ch = gbuf_k.shape[0]
    print(f"{what}: {pa.shape[0]} attribute rows, {n_ch} channels; "
          f"{frac_differ:.3e} of pixels differ (limit 1e-3), channels max "
          f"|err| {err_b:.3e} (limit 1e-4), {covered:.3f} covered",
          flush=True)
    check(frac_differ <= 1e-3, f"{what} winners/depth vs plain")
    check(err_b <= 1e-4, f"{what} channels vs plain")
    del depth_p, vis_p, gbuf_p
    n_pix = vis_k.numel()
    live = int(pairs.tile_count.sum())
    win_slots = int(winner_slots(vis_k, pairs, mv.n_tiles_x, mv.sub)
                    .unique().numel())
    b_bytes = 4 * N_STAGED * live + 4 * pa.shape[0] * win_slots \
        + 8 * pairs.tile_start.shape[0] + n_pix * 4 * (2 + n_ch)
    evaluated = evaluated_pair_pixels(pe, pairs, mv.n_tiles_x, mv.sub)
    sizes, least = block_work(pe, pairs, mv.n_tiles_x, mv.sub, z=True)
    tests, px = sizes[least]
    counts = pairs.tile_count
    print(f"{what}: {live} pairs, per bin max {int(counts.max())} mean "
          f"{float(counts.float().mean()):.1f}; block tests and pixels in "
          f"passing blocks {sizes} (least: {least}; {evaluated:.0f} pixels "
          f"in the pairs' rows)", flush=True)
    per_px = (80 + 10 * (n_ch - 13)) * float((vis_k >= 0).sum())
    b_ops = 12 * (tests + px) + per_px
    ctx.kernel("gbuffer", lambda: raster.rasterize_gbuffer(
        pe, pa, pairs, mv.n_tiles_y, mv.n_tiles_x, sub=mv.sub,
        row_skip=True), 20, lambda: raster.gbuffer_plain(*gb_args), 2,
        (b_bytes / HBM_BYTES_PER_S, b_ops / FP32_OPS_PER_S), err_b,
        variant=variant)
    result = ctx.results["gbuffer"] if variant is None \
        else ctx.variants["gbuffer"][variant]
    result.update(ops=b_ops, pr6_design_ops=12 * evaluated + per_px,
                  block_work=sizes, block_least=least)
    return frac_differ, err_b, covered, evaluated


def check_and_time_c(ctx, scene, gbuf, vis):
    """Kernel C on the frame's material ids, exact; yardstick one PyTorch
    gather of the same table rows (pixel-major output; the id clip and
    valid select folded into a precomputed index into a table with a zero
    row 128)."""
    mat_id = torch.floor(gbuf[raster._CH_MAT] * 0.5)
    valid = vis >= 0
    table = post.material_table_lanes(scene["material_table"])
    check(torch.equal(post.material_kernel(table, mat_id, valid),
                      post.material_plain(table, mat_id, valid)),
          "kernel C equals the plain version")
    print("kernel C: equal", flush=True)
    table_rows = torch.cat([table.T, torch.zeros(1, table.shape[0],
                                                 device=ctx.dev)])
    gather_idx = torch.where(valid, mat_id.long().clamp(0, 127),
                             128).reshape(-1)
    n_pix = vis.numel()
    c_bytes = n_pix * (4 + 1 + 4 * table.shape[0]) + table.numel() * 4
    ctx.kernel("material", lambda: post.material_kernel(table, mat_id, valid),
               50, lambda: post.material_plain(table, mat_id, valid), 20,
               (c_bytes / HBM_BYTES_PER_S, 0.0), 0.0,
               lambda: table_rows.index_select(0, gather_idx))


def check_and_time_d(ctx, scene, targs, kw, what="kernel D",
                     variant=None) -> dict:
    """Kernel D on a frame's recorded inputs against its plain version (ok
    equal on every pixel, values within 1e-5 where ok), then timed with
    its bound: uv, 4 derivatives, id and valid (29 B) read and 9 f32 (36
    B) written per pixel, plus 8 B for every distinct pool word that the
    taps of the ok pixels read (sample_plain's words; window_count_bytes
    keeps the looser count of every sampled window whole); no single PyTorch call
    computes a windowed, fallback-masked brick sample."""
    mat_id, valid = targs[2], targs[3]
    n_pix = valid.numel()
    tex_k = texture.sample_materials(*targs, **kw)
    words = []
    tex_p = texture.sample_plain(*targs, **kw, words=words)
    ok_k, ok_p = tex_k[8] > 0.5, tex_p[8] > 0.5
    both_ok = ok_k & ok_p
    val_err = (tex_k[:8] - tex_p[:8]).abs().amax(dim=0)
    err_d = float(val_err[both_ok].max()) if bool(both_ok.any()) else 0.0
    bad_px = (ok_k != ok_p) | (both_ok & (val_err > 1e-5))
    tiles_differ = float(texture.to_thread_layout(bad_px).flatten(1)
                         .any(dim=1).float().mean())
    ok_share = float(ok_k[valid].float().mean())
    flags = {k: kw[k] for k in ("trilinear", "aniso", "two_mat",
                                "mip_bias")}
    print(f"{what} {flags}: ok equal on "
          f"{float((ok_k == ok_p).float().mean()):.6f} of pixels, values "
          f"max |err| {err_d:.3e} (limit 1e-5), {tiles_differ:.3e} of "
          f"tiles differ; {ok_share:.4f} of covered pixels textured",
          flush=True)
    check(bool((ok_k == ok_p).all()), f"{what} ok channel vs plain")
    check(err_d <= 1e-5, f"{what} values vs plain")
    n_valid_t, dom_t, _, needs2_t = texture.tile_materials(
        texture.to_thread_layout(mat_id).to(torch.int32),
        texture.to_thread_layout(valid), scene["mat_tex"])
    dom_windows = int(((scene["mat_tex"][dom_t.long()] >= 0)
                       & (n_valid_t > 0)).sum())
    windows = (2 * dom_windows if kw["trilinear"]
               else dom_windows + int(needs2_t.sum()) * kw["two_mat"])
    distinct = int(torch.cat(words).unique().numel()) if words else 0
    del words
    # taps per sampled pixel: 4 texels of 2 words per bilinear tap, 3 taps
    # under aniso, 2 windows under trilinear; ~60 flops per tap
    taps = (3 if kw["aniso"] else 1) * (2 if kw["trilinear"] else 1)
    d_bytes = n_pix * 65 + distinct * 8
    d_ops = float(ok_k.sum()) * taps * 60
    ctx.kernel("texture", lambda: texture.sample_materials(*targs, **kw), 20,
               lambda: texture.sample_plain(*targs, **kw), 3,
               (d_bytes / HBM_BYTES_PER_S, d_ops / FP32_OPS_PER_S), err_d,
               variant=variant)
    result = ctx.results["texture"] if variant is None \
        else ctx.variants["texture"][variant]
    result.update(
        distinct_texel_words=distinct, windows=windows, window_count_bytes=(
            n_pix * 65 + windows * texture.WIN_H * texture.WIN_W * 8))
    return dict(tiles_differ=tiles_differ, ok_share=ok_share,
                windows=windows, distinct_texel_words=distinct)


def check_and_time_e(ctx, atlas, n_cas, variant=None):
    """Kernel E on the frame's opaque casters, exact against its plain
    version; bound: the atlas written, the 14 staged rows of each live pair
    and each bin's start/count read; operations: 12 rounded ops per corner
    test of a (pair, block) in the pair's rows and per pixel of the blocks
    that pass, at the block size that needs the fewest (block_work; the
    kernel tests 16 x 16 blocks). The PR 6 design's count, 12 per pixel of
    every 16-px row of the bin inside the pair's rows
    (evaluated_pair_pixels), is kept beside it: the new count is the
    smaller, so the bound is a floor for both designs."""
    eargs = (atlas.edges, atlas.pairs, atlas.n_bins_y, atlas.n_bins_x)
    pargs_e = (atlas.edges, atlas.pairs.tile_start, atlas.pairs.tile_count,
               atlas.n_bins_y, atlas.n_bins_x, atlas.sub, True)
    depth_e = raster.rasterize_depth(*eargs, sub=atlas.sub, row_skip=True)
    what = "kernel E" if variant is None else f"kernel E ({variant})"
    check(torch.equal(depth_e.view(torch.int32),
                      raster.depth_plain(*pargs_e).view(torch.int32)),
          f"{what} atlas equals the plain version")
    cov = float((depth_e > 0).float().mean())
    counts = atlas.pairs.tile_count
    live = int(counts.sum())
    q = torch.quantile(counts.float(), torch.tensor(
        [0.5, 0.9, 0.99], device=counts.device)).tolist()
    e_eval = evaluated_pair_pixels(atlas.edges, atlas.pairs, atlas.n_bins_x,
                                   atlas.sub)
    sizes, least = block_work(atlas.edges, atlas.pairs, atlas.n_bins_x,
                              atlas.sub)
    e_ops = 12 * sum(sizes[least])
    print(f"{what}: {n_cas} x {atlas.n_bins_x * raster.TILE_W}^2 atlas "
          f"equal; {cov:.3f} covered; {live} pairs, per bin max "
          f"{int(counts.max())} mean {float(counts.float().mean()):.1f} "
          f"p50/p90/p99 {q}; block tests and pixels in passing blocks "
          f"{sizes} (least: {least}; {e_eval:.0f} pixels in the pairs' "
          "rows)", flush=True)
    e_bytes = (depth_e.numel() * 4 + 4 * N_STAGED * live
               + 8 * counts.shape[0])
    ctx.kernel("depth", lambda: raster.rasterize_depth(
        *eargs, sub=atlas.sub, row_skip=True), 20,
        lambda: raster.depth_plain(*pargs_e), 1,
        (e_bytes / HBM_BYTES_PER_S, e_ops / FP32_OPS_PER_S), 0.0,
        variant=variant)
    result = ctx.results["depth"] if variant is None \
        else ctx.variants["depth"][variant]
    result.update(
        ops=e_ops, block_work=sizes, block_least=least,
        pr6_design_ops=12 * e_eval,
        pr6_design_bound_ms=12 * e_eval / FP32_OPS_PER_S * 1e3)
    return dict(atlas_covered=cov, atlas_evaluated_pair_pixels=e_eval,
                atlas_block_work=sizes, atlas_block_least=least,
                atlas_pairs=live, atlas_pairs_per_bin_quantiles=q,
                atlas_pairs_per_bin=dict(
                    max=int(counts.max()), mean=float(counts.float().mean()),
                    nonzero_bins=int((counts > 0).sum())))


def check_and_time_f(ctx, atlas, resolve_args, settings, valid):
    """Kernel F on the frame's world position, depth and noise against
    its plain version (>= 99.9% equal, the rest within 1/taps); bound:
    20 B read and 4 B written per pixel plus 4 B for every distinct map
    word that a tap inside the map reads (shadow_resolve_plain's words;
    map_count_bytes keeps the looser count of every word of the used
    cascades' maps), ~24 flops per tap per covered pixel."""
    n_cas = settings.shadows.cascade_count
    sres = settings.shadows.resolution
    taps = settings.shadows.pcf_taps
    pargs = (*resolve_args[:3], shadow.pack_shadow_maps_u16(atlas.maps),
             shadow.cascade_rows(atlas.cascade_mats, atlas.cascade_scales,
                                 atlas.splits),
             n_cas, taps, settings.shadows.sample_radius)
    sh_k = shadow.resolve_packed(*pargs)
    words = []
    diff_f = (sh_k - shadow.shadow_resolve_plain(*pargs, sres,
                                                 words=words)).abs()
    distinct = int(torch.cat(words).unique().numel()) if words else 0
    del words
    f_equal = float((diff_f == 0).float().mean())
    err_f = float(diff_f.max())
    shadowed = float((sh_k[valid] < 0.5).float().mean())
    print(f"kernel F: {f_equal:.6f} of pixels equal (limit 0.999), max "
          f"|err| {err_f:.4f} (limit 1/{taps}); {shadowed:.3f} of covered "
          f"pixels in shadow; {distinct} distinct map words read",
          flush=True)
    check(f_equal >= 0.999, "kernel F vs plain")
    check(err_f <= 1.0 / taps + 1e-6, "kernel F error bound")
    n_pix = valid.numel()
    ctx.kernel("shadow", lambda: shadow.resolve_packed(*pargs), 20,
               lambda: shadow.shadow_resolve_plain(*pargs, sres), 3,
               ((n_pix * 24 + distinct * 4) / HBM_BYTES_PER_S,
                float(valid.sum()) * taps * 24 / FP32_OPS_PER_S), err_f)
    ctx.results["shadow"].update(
        distinct_map_words=distinct,
        map_count_bytes=n_pix * 24 + n_cas * (sres // 2) * sres * 4)
    return dict(shadow_equal_share=f_equal, shadowed_share=shadowed,
                shadow_distinct_map_words=distinct)


def check_and_time_g(ctx, trace_args) -> dict:
    """Kernel G on a frame's recorded trace inputs against its plain
    version (escaped and hit/miss equal on >= 99.9% of rays, values
    within 1e-4 abs + rel where both agree); bound from this run's
    inputs: every ray reads its valid flag (1 B) and writes 7 f32, a
    valid ray reads 9 f32 more, plus the bricks, the sky and the coarse
    tables; operations from the loop steps the plain version counts."""
    t_scene, inp, t_settings, sun_dir, sun_col, sun_str = trace_args
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
    del ref, out_k
    n_valid = int(valid3.sum())
    sdf_bytes = t_scene["sdf_volume"].nbytes + t_scene["sdf_albedo"].nbytes
    g_bytes = (inp.valid.element_size() * n_rays + 7 * 4 * n_rays
               + 9 * 4 * n_valid + sdf_bytes + inp.sky_lowres.nbytes
               + sum(t.nbytes for t in t_scene["sdf_coarse"][:2]))
    g_ops = (G_FINE_STEP_OPS * g_stats["fine_steps"]
             + G_SHADOW_STEP_OPS * g_stats["shadow_steps"]
             + G_COARSE_STEP_OPS * (g_stats["coarse_steps"]
                                    + g_stats["coarse_shadow_steps"])
             + G_RAY_OPS * g_stats["rays"])
    ctx.kernel("sdfgi_trace", lambda: sdfgi.trace_gi(*g_args, **g_kw), 20,
               lambda: sdfgi.trace_gi(*g_args, plain=True, **g_kw), 2,
               (g_bytes / HBM_BYTES_PER_S, g_ops / FP32_OPS_PER_S), err_g)
    return dict(gi_planes=[gh, gw], trace_escaped_equal=esc_equal,
                trace_hit_equal=hit_equal, trace_hit_share=hit_share,
                trace_escaped_share=escaped_share, trace_loop_steps=g_stats)


def check_and_time_h(ctx, resample_args) -> dict:
    """Kernel H on a frame's recorded GI history and motion (every bit of
    its output equal to the plain version's); bound 48 B per pixel;
    yardstick grid_sample of the unpacked planes."""
    planes_h, motion_h, width_h, height_h = resample_args
    coords_h = taa.reprojected_coords(motion_h, width_h, height_h)
    err_h, h_ok_share = compare_history(
        "kernel H", planes_h, 6, taa.packed_planes(planes_h, coords_h),
        taa.packed_planes_plain(planes_h, coords_h))
    hh, hw = planes_h.shape[1:]
    unpacked = torch.stack([c for p in planes_h
                            for c in taa.unpack_f16_pair_flush(p)])[None]
    ctx.kernel("packed_planes", lambda: taa.packed_planes(planes_h, coords_h),
               50, lambda: taa.packed_planes_plain(planes_h, coords_h), 10,
               (48 * hh * hw / HBM_BYTES_PER_S, 0.0), err_h,
               grid_sample(unpacked, coords_h))
    return dict(history_planes=list(planes_h.shape),
                history_ok_share=h_ok_share)


def check_and_time_i(ctx, coords_args, history) -> dict:
    """Kernel I on a frame's recorded TAA history: K = 1 at the frame's
    tech-4 coords and K = 16 at tech-1 coords of the same (dilated)
    motion; bound (K = 1) 8 B of coords and 4 B of history read and 3 f32
    + ok written per pixel; yardstick grid_sample of the unpacked
    history."""
    motion, width, height, tech = coords_args
    check(tech == 4, "the default history sampler is tech 4")
    coords4 = taa.history_coords(motion, width, height, 4)[0]
    res = {}
    for k, coords in ((1, coords4),
                      (16, taa.history_coords(motion, width, height, 1)[0])):
        # R11G11B10 values are >= 0: the taps' magnitude is the value
        out_p = taa.history_taps_plain(history, coords)
        res[k] = compare_history(f"kernel I (K={k})", history, 3 * k,
                                 taa.history_taps(history, coords), out_p,
                                 out_p)
        del out_p
    hh, hw = history.shape
    ctx.kernel("history_taps", lambda: taa.history_taps(history, coords4),
               50, lambda: taa.history_taps_plain(history, coords4), 10,
               (28 * hh * hw / HBM_BYTES_PER_S, 0.0), res[1][0],
               grid_sample(color_packing.unpack_r11g11b10(history)[None],
                           coords4))
    return dict(taa_planes=[hh, hw],
                history_taps={str(k): dict(max_abs_err=e, ok_share=o)
                              for k, (e, o) in res.items()})


# --------------------- per-slice kernel comparisons ---------------------

def check_keys(ki, what: str, per: str):
    """Kernel A's keys and owners equal to its plain version; returns the
    live pairs and the bound (bytes s, operations s): it reads 3 words per
    triangle and writes 2 per slot, and a live pair costs a binary search
    over the triangles plus ~20 ops."""
    keys_k, own_k = raster.expand_keys(ki)
    keys_p, own_p = raster.expand_keys_plain(ki)
    check(torch.equal(keys_k, keys_p) and torch.equal(own_k, own_p),
          f"{what} keys/owners equal the plain version")
    live, t = int(ki.cum[-1]), ki.cum.shape[0]
    print(f"{what}: {ki.budget} slots, {live} live, {per}={ki.tpv}: equal",
          flush=True)
    return live, (4 * (3 * t + 2 * ki.budget) / HBM_BYTES_PER_S,
                  live * (3 * max(1, int(np.ceil(np.log2(t)))) + 20)
                  / INT32_OPS_PER_S)


def slice1_kernels(ctx, frames, settings) -> dict:
    """Kernels A, B, C at frame 0's shapes against their plain versions."""
    mv = frame.main_view_setup(frames[0], ctx.cams[0], settings)
    ki = raster.pair_key_inputs(mv.setup, mv.n_tiles_y, mv.n_tiles_x,
                                mv.pair_budget, mv.sub, order_rows=True)
    live_pairs, a_bound = check_keys(ki, "kernel A", "T")
    main = frame.raster_main_view(mv)
    check(int(main.overflow) == 0, "no pairs dropped at the bench framing")
    frac_differ, _, covered, evaluated = check_and_time_b(
        ctx, mv, main.pairs, main.pair_edges, main.pair_attrs)
    check(covered > 0.3, "the frame covers the screen")
    check_and_time_c(ctx, frames[0], main.gbuf, main.vis)
    time_keys(ctx, ki, a_bound)
    small = small_card_vs_cpu(ctx, 1, textured=False)
    return dict(gbuffer_pixels_differ=frac_differ, small_close=small,
                live_pairs=live_pairs, pair_budget=ki.budget,
                evaluated_pair_pixels=evaluated)


def pick_pair_budget_scale(ctx, frames, row):
    """The smallest power-of-two pair budget scale that drops nothing over
    the camera path (the JAX app escalates the same way,
    runtime/app.py:197)."""
    scale = 1.0
    while True:
        settings = dataclasses.replace(slice_settings(row.n, WIDTH, HEIGHT),
                                       pair_budget_scale=scale)
        probe = drive(ctx, frames, settings, len(ctx.cams), 0)
        dropped = probe["counters"].max(axis=0).tolist()
        print(f"pair_budget_scale {scale}: most dropped per frame "
              f"(main, atlas) {dropped}", flush=True)
        if max(dropped) == 0:
            return scale
        scale *= 2.0
        check(scale <= 64.0, "pair budget scale bounded")


def atlas_keys(atlas, settings, what):
    """Kernel A's multi-view keys of the atlas's opaque casters, equal to
    the plain version; returns (KeyInputs, live pairs, bound)."""
    n_cas = settings.shadows.cascade_count
    setup = atlas.setup
    if atlas.alpha is not None:
        setup = frame.opaque_stream(setup, setup.edges[2, 7] > 0.5)
    ki2 = raster.pair_key_inputs(setup, atlas.n_bins_y, atlas.n_bins_x,
                                 atlas.pair_budget, atlas.sub,
                                 order_rows=True, n_views=n_cas)
    live, bound = check_keys(ki2, what, "T/view")
    return ki2, live, bound


def slice2_kernels(ctx, frames, settings) -> dict:
    """Kernel D, the shadow atlas's multi-view keys (kernel A), depth
    raster (kernel E) and PCF resolve (kernel F) on frame 0's inputs,
    recorded on their way into the kernels."""
    rec = record_frames(ctx, frames, settings, 1,
                        [(texture, "sample_materials"),
                         (frame, "render_shadow_atlas"),
                         (shadow, "shadow_resolve")])
    targs = rec["sample_materials"][0]
    d = check_and_time_d(ctx, frames[0], targs, texture_kwargs(settings))
    check(d["ok_share"] > 0.5, "most covered pixels are textured")
    atlas = frame.render_shadow_atlas(*rec["render_shadow_atlas"][0])
    check(int(atlas.pairs.overflow) == 0, "no atlas pairs dropped")
    ki2, atlas_live, atlas_bound = atlas_keys(
        atlas, settings, f"kernel A (atlas, "
        f"{settings.shadows.cascade_count} views)")
    time_keys(ctx, atlas_ki=ki2, atlas_bound=atlas_bound)
    e = check_and_time_e(ctx, atlas, settings.shadows.cascade_count)
    f = check_and_time_f(ctx, atlas, rec["shadow_resolve"][0], settings,
                         targs[3])
    check(0.01 < f["shadowed_share"] < 0.99,
          "the frame has light and shadow")
    small = small_card_vs_cpu(ctx, 2, textured=True)
    return dict(
        pair_budget_scale=ctx.scale, small_close=small,
        texture_tiles_differ=d["tiles_differ"],
        texture_ok_share=d["ok_share"], texture_windows=d["windows"], **f,
        atlas_live_pairs=atlas_live, atlas_pair_budget=atlas.pair_budget,
        **e)


def record_frames(ctx, frames, settings, n: int, targets):
    """Render the first n of the per-frame scenes from a fresh state with
    each (module, name) in targets wrapped to record its positional
    arguments, in call order."""
    recorded = {name: [] for _, name in targets}
    originals = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def recorder(fn, seen):
        return lambda *args, **kw: (seen.append(args), fn(*args, **kw))[1]
    for mod, name, fn in originals:
        setattr(mod, name, recorder(fn, recorded[name]))
    try:
        state = initial_state(WIDTH, HEIGHT, device=ctx.dev)
        for i in range(n):
            _, state = frame.render_frame(
                state, frames[i], ctx.cams[i], ctx.luts, 1.0 / 60.0,
                settings, device=ctx.dev)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return recorded


def slice3_kernels(ctx, frames, settings) -> dict:
    """Kernel G on frame 0's trace inputs and kernel H on frame 1's GI
    history, recorded on their way into the kernels."""
    print(f"slice 3 settings: {settings.sdf_trace}; pair_budget_scale "
          f"{ctx.scale}", flush=True)
    rec = record_frames(ctx, frames, settings, 2,
                        [(frame, "trace_scene_gi"),
                         (taa, "resample_packed_planes")])
    g = check_and_time_g(ctx, rec["trace_scene_gi"][0])
    h = check_and_time_h(ctx, rec["resample_packed_planes"][1])
    small = small_card_vs_cpu(ctx, 3, textured=True, gi=True, moving=True)
    return dict(pair_budget_scale=ctx.scale, **ctx.extra["sdf"], **g, **h,
                small_close=small)


def grid_sample(planes, coords):
    """One F.grid_sample (bilinear, border, no window rule) of (1, C, H, W)
    planes at absolute pixel coords (2, H, W), as a call to time: the
    history kernels' yardstick."""
    hh, hw = planes.shape[-2:]
    grid = torch.stack([coords[0] / hw * 2.0 - 1.0,
                        coords[1] / hh * 2.0 - 1.0], dim=-1)[None]
    return lambda: torch.nn.functional.grid_sample(
        planes, grid, mode="bilinear", padding_mode="border",
        align_corners=False)


def compare_history(what, words, n, out_k, out_p, magnitude=None):
    """A history kernel's (n + 1, H, W) output against its plain version:
    ok (the last channel) equal on every pixel, values within 1e-6 of the
    taps' magnitude, or (magnitude None) every value's bits equal.
    Returns (max |err|, ok share)."""
    nonzero = float((words != 0).float().mean())
    ok_equal = bool(torch.equal(out_k[n], out_p[n]))
    diff = (out_k[:n] - out_p[:n]).abs()
    err = float(diff.max())
    ok_share = float(out_k[n].mean())
    rule = ("every value's bits equal" if magnitude is None
            else "limit 1e-6 of the taps' magnitude")
    print(f"{what}: {tuple(words.shape)} history ({nonzero:.4f} of words "
          f"nonzero); ok equal: {ok_equal}, values max |err| {err:.3e} "
          f"({rule}); {ok_share:.4f} of pixels reproject inside the "
          "window", flush=True)
    check(nonzero > 0.1, f"{what}: frame 1's history is not empty")
    check(ok_equal, f"{what} ok channel vs plain")
    if magnitude is None:
        check(same_bits(out_k, out_p), f"{what} bits vs plain")
    else:
        check(float((diff - 1e-6 * magnitude[:n]).max()) <= 0.0,
              f"{what} values vs plain")
    return err, ok_share


def slice4_kernels(ctx, frames, settings) -> dict:
    """Kernel I on frame 1's TAA history (check_and_time_i); then the
    golden scene on the card."""
    print(f"slice 4 settings: {settings.taa}; {settings.bloom}; "
          f"{settings.volumetrics}; pair_budget_scale {ctx.scale}",
          flush=True)
    rec = record_frames(ctx, frames, settings, 2,
                        [(taa, "history_coords"),
                         (taa, "resample_history_taps")])
    found = check_and_time_i(ctx, rec["history_coords"][1],
                             rec["resample_history_taps"][1][0])
    # the golden scene (tools/make_golden.py:33-58) on the card and the CPU
    gold = config.RenderSettings(
        width=256, height=128,
        sdf_trace=config.SDFTraceSettings(enabled=True, trace_steps=16),
        shadows=config.ShadowSettings(resolution=512),
        exposure_adaption_speed=1000.0)
    card, cpu = small_images(ctx, gold, textured=True, gi=True)
    want = np.load(ROOT / "tests" / "golden_frame.npz")["image"]
    close_golden = golden_close(card, want)
    close_cpu = golden_close(card, cpu)
    print(f"golden scene on the card: {close_golden:.5f} of pixels within "
          f"2 LSB of tests/golden_frame.npz, {close_cpu:.5f} of the CPU "
          "plain path (limit > 0.999)", flush=True)
    check(close_golden > 0.999, "golden scene on the card vs golden_frame")
    check(close_cpu > 0.999, "golden scene card vs CPU")
    return dict(pair_budget_scale=ctx.scale, **found,
                golden_close=close_golden, golden_card_vs_cpu=close_cpu)


def retime_a_to_i(ctx, frames, settings):
    """Kernels A-I again, each checked against its plain version (A on all
    four of frame 0's streams) and timed on this row's own frame inputs
    (frames 0 and 1, recorded on their way into the kernels), so that the
    kernels line's timed_on names this row;
    the earlier rows' times stay under `earlier`. Returns the recorded
    calls."""
    rec = record_frames(ctx, frames, settings, 2, [
        (frame, "raster_main_view"), (frame, "render_shadow_atlas"),
        (texture, "sample_materials"), (shadow, "shadow_resolve"),
        (frame, "trace_scene_gi"), (taa, "resample_packed_planes"),
        (taa, "history_coords"), (taa, "resample_history_taps"),
        (raster, "expand_keys")])
    # kernel A on each of frame 0's four pair streams (the main view's
    # alpha and opaque streams, the atlas's opaque and alpha casters)
    check(len(rec["expand_keys"]) == 8, "kernel A runs 4 times a frame")
    for n, (ki_n,) in enumerate(rec["expand_keys"][:4]):
        check_keys(ki_n, f"kernel A (frame 0, stream {n + 1} of 4)",
                   "T/view" if ki_n.tpv < ki_n.cum.shape[0] else "T")
    mv = rec["raster_main_view"][0][0]
    main = frame.raster_main_view(mv)
    setup_o = main_opaque_stream(mv)
    ki = raster.pair_key_inputs(setup_o, mv.n_tiles_y, mv.n_tiles_x,
                                mv.pair_budget, mv.sub, order_rows=True)
    _, a_bound = check_keys(ki, "kernel A (opaque main stream)", "T")
    time_keys(ctx, ki, a_bound)
    check_and_time_b(ctx, mv, main.pairs, main.pair_edges, main.pair_attrs)
    check_and_time_c(ctx, frames[0], main.gbuf, main.vis)
    targs = rec["sample_materials"][0]
    check_and_time_d(ctx, frames[0], targs, texture_kwargs(settings))
    atlas = frame.render_shadow_atlas(*rec["render_shadow_atlas"][0])
    ki2, _, atlas_bound = atlas_keys(atlas, settings,
                                     "kernel A (atlas, opaque casters)")
    time_keys(ctx, atlas_ki=ki2, atlas_bound=atlas_bound)
    check_and_time_e(ctx, atlas, settings.shadows.cascade_count)
    check_and_time_f(ctx, atlas, rec["shadow_resolve"][0], settings,
                     targs[3])
    check_and_time_g(ctx, rec["trace_scene_gi"][0])
    check_and_time_h(ctx, rec["resample_packed_planes"][1])
    check_and_time_i(ctx, rec["history_coords"][1],
                     rec["resample_history_taps"][1][0])
    return rec


def main_opaque_stream(mv):
    """The main view's opaque stream, as the frame bins it."""
    if mv.alpha_slots is None:
        return mv.setup
    return frame.opaque_stream(mv.setup, mv.alpha_slots > 0)


def check_and_time_l(ctx, mv, main, vis_k, variant=None):
    """Kernel L on kernel K's vis against its plain version (channels
    within kernel B's 1e-4), timed; bound: it reads vis, writes every
    channel of every pixel and reads the attribute rows of the distinct
    winning triangles, ~80 flops per covered pixel (+10 per extra
    channel). Returns (max |err|, winners)."""
    pa, pa_a = main.alpha_pairs, main.alpha_attrs
    l_args = (pa_a, pa.tile_start, vis_k, mv.n_tiles_y, mv.n_tiles_x,
              mv.sub)
    gbuf_l = raster.resolve_attributes(*l_args)
    err_l = float((gbuf_l - raster.attr_resolve_plain(*l_args)).abs().max())
    n_ch = gbuf_l.shape[0]
    print(f"kernel L: {pa_a.shape[0]} attribute rows, {n_ch} channels; max "
          f"|err| {err_l:.3e} (limit 1e-4, kernel B's)", flush=True)
    check(err_l <= 1e-4, "kernel L channels vs plain")
    n_pix = vis_k.numel()
    covered = int((vis_k >= 0).sum())
    tri_k = raster.winner_triangle_ids(vis_k, pa, mv.n_tiles_x, mv.sub)
    winners = int(tri_k[tri_k >= 0].unique().numel())
    l_bytes = (4 * n_pix + 4 * n_ch * n_pix + 4 * pa_a.shape[0] * winners
               + 4 * pa.tile_start.numel())
    ctx.kernel("attr_resolve", lambda: raster.resolve_attributes(*l_args),
               20, lambda: raster.attr_resolve_plain(*l_args), 5,
               (l_bytes / HBM_BYTES_PER_S,
                (80 + 10 * (n_ch - 13)) * covered / FP32_OPS_PER_S), err_l,
               variant=variant)
    return err_l, winners


def check_and_time_m(ctx, mv, main, variant=None) -> dict:
    """Kernel M's own path: build_pairs(carry_table=...) on the frame's
    opaque main-view stream, launch counts reset just before it; the
    carried rows equal gather_pair_setups on every live slot and the
    kernel its plain version, bit for bit. Bound: the owners of the live
    slots and the table columns of the distinct owners read, every slot
    of every row written (0 when dead); yardstick one index_select."""
    setup_o = main_opaque_stream(mv)
    table, _ = raster.setup_row_table(setup_o, row_extents=True)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    pairs_m, rows_m = raster.build_pairs(
        setup_o, mv.n_tiles_y, mv.n_tiles_x, pair_budget=mv.pair_budget,
        bin_rows=mv.sub, order_rows=True, carry_table=table)
    torch.cuda.synchronize()
    m_counts = native.launch_counts()
    check(m_counts["expand_rows"] == 1 and m_counts["expand_keys"] == 1,
          f"build_pairs(carry_table) launches A and M once: {m_counts}")
    for k in ("pair_tri", "tile_start", "tile_count"):
        check(torch.equal(getattr(pairs_m, k), getattr(main.pairs, k)),
              f"carry_table gives the frame's segments ({k})")
    live = int(main.pairs.tile_count.sum())
    check(torch.equal(rows_m[:, :live], torch.cat(
        [main.pair_edges, main.pair_attrs])[:, :live]),
        "kernel M's rows equal gather_pair_setups on every live slot")
    ki = raster.pair_key_inputs(setup_o, mv.n_tiles_y, mv.n_tiles_x,
                                mv.pair_budget, mv.sub, order_rows=True)
    _, owners = raster.expand_keys(ki)
    m_args = (owners, table, ki.cum[-1:], ki.budget)
    check(torch.equal(raster.expand_rows(*m_args),
                      raster.expand_rows_plain(*m_args)),
          "kernel M equals the plain version")
    live_m = int(ki.cum[-1])
    n_owners = int(owners[:live_m].unique().numel())
    print(f"kernel M: {table.shape[0]} rows x {ki.budget} slots "
          f"({live_m} live, {n_owners} owners), equal; the carried rows "
          f"equal gather_pair_setups on all {live} live slots; launches on "
          f"its path {m_counts}", flush=True)
    m_bytes = 4 * (live_m + table.shape[0] * ki.budget
                   + table.shape[0] * n_owners)
    ctx.kernel("expand_rows", lambda: raster.expand_rows(*m_args), 50,
               lambda: raster.expand_rows_plain(*m_args), 10,
               (m_bytes / HBM_BYTES_PER_S, 0.0), 0.0,
               lambda: table.index_select(1, owners.long()), variant=variant)
    return dict(rows=table.shape[0], slots=ki.budget, live=live_m,
                owners=n_owners, launches=m_counts)


def check_j(atlas, settings, what):
    """Kernel J on the atlas's alpha casters, merged in place onto kernel
    E's atlas of the frame's opaque casters (E again gives the atlas J
    started from), exact against its plain version and equal to the
    frame's atlas. Returns (J's atlas, E's, J's plain arguments)."""
    a = atlas.alpha
    check(a is not None and int(atlas.overflow) == 0,
          f"{what}: the atlas has an alpha stream and drops nothing")
    init = raster.rasterize_depth(atlas.edges, atlas.pairs, atlas.n_bins_y,
                                  atlas.n_bins_x, sub=atlas.sub,
                                  row_skip=True)
    j_args = (a.edges, a.pairs.tile_start, a.pairs.tile_count, a.n_bins_y,
              atlas.n_bins_x, a.sub, False)
    depth_j = raster.rasterize_depth(a.edges, a.pairs, a.n_bins_y,
                                     atlas.n_bins_x, sub=a.sub,
                                     alpha_masks=a.masks,
                                     init_depth=init.clone())
    check(torch.equal(depth_j.view(torch.int32),
                      raster.depth_plain(*j_args, masks=a.masks, init=init)
                      .view(torch.int32)),
          f"{what} atlas equals the plain version")
    n_cas = settings.shadows.cascade_count
    check(torch.equal(depth_j, atlas.maps[:n_cas].reshape(depth_j.shape)),
          f"{what}'s result is the frame's atlas")
    return depth_j, init, j_args


def slice5_kernels(ctx, frames, settings) -> dict:
    """Kernels A-I again on this row's frame inputs (retime_a_to_i), then
    kernels J, K and L on frame 0's alpha streams (the atlas's and the
    main view's, recomputed from the recorded inputs of the frame's own
    calls), the alpha test's work, kernel M in a phase of its own on the
    frame's main-view setup, and the small banner scene card vs CPU."""
    print(f"slice 5 settings: default RenderSettings(); pair_budget_scale "
          f"{ctx.scale}", flush=True)
    rec = retime_a_to_i(ctx, frames, settings)
    atlas = frame.render_shadow_atlas(*rec["render_shadow_atlas"][0])
    a = atlas.alpha
    depth_j, init, j_args = check_j(atlas, settings, "kernel J")
    uncut_j = raster.depth_plain(*j_args, init=init)
    raised = int((depth_j > init).sum())
    rejected_j = int((uncut_j > depth_j).sum())
    # texels a caster covers and passes: those J reads (and writes if
    # raised)
    passing = int((raster.depth_plain(*j_args, masks=a.masks) > 0).sum())
    a_pairs = int(a.pairs.tile_count.sum())
    print(f"kernel J: {a_pairs} alpha caster pairs in {a.n_bins_y} x "
          f"{atlas.n_bins_x} bins of {a.sub * 16} rows; atlas equal; "
          f"{passing} texels covered by a passing caster, {raised} raised "
          f"over the opaque atlas, {rejected_j} where the masks rejected "
          "every covering caster", flush=True)
    check(raised > 0 and rejected_j > 0, "the alpha casters write and cut")
    del uncut_j
    j_counts = stream_counts(a.edges, a.pairs, atlas.n_bins_x, a.sub,
                             row_skip=False, z=False)
    print(f"kernel J's stream: {j_counts}", flush=True)

    mv = rec["raster_main_view"][0][0]
    main = frame.raster_main_view(mv)
    check(int(main.overflow) == 0, "no main-view pairs dropped")
    pa, pe_a, pa_a = main.alpha_pairs, main.alpha_edges, main.alpha_attrs
    k_args = (pe_a, pa.tile_start, pa.tile_count, mv.alpha_masks,
              mv.n_tiles_y, mv.n_tiles_x, mv.sub, True)
    depth_k, vis_k = raster.rasterize_winner_alpha(
        pe_a, pa, mv.alpha_masks, mv.n_tiles_y, mv.n_tiles_x, mv.sub, True)
    depth_kp, vis_kp = raster.winner_alpha_plain(*k_args)
    check(torch.equal(depth_k, depth_kp) and torch.equal(vis_k, vis_kp),
          "kernel K depth and vis equal the plain version")
    # the alpha test's work: pixels the alpha stream's edges (and z) cover,
    # and those where the masks reject every covering pair
    # (a mask of all ones passes every pair: the edges and z alone)
    _, vis_edges = raster.winner_alpha_plain(
        *k_args[:3], torch.full_like(mv.alpha_masks, -1), *k_args[4:])
    edge_px = int((vis_edges >= 0).sum())
    rejected = int(((vis_edges >= 0) & (vis_k < 0)).sum())
    # pixels of the merged frame at the alpha stream's depth (it won, or
    # tied and the opaque stream won)
    alpha_wins = int(((depth_k > 0) & (main.depth == depth_k)).sum())
    print(f"kernel K: {int(pa.tile_count.sum())} alpha pairs; depth and "
          f"vis equal; the alpha stream's edges cover {edge_px} pixels, "
          f"the masks reject {rejected} of them; {alpha_wins} pixels of "
          "the merged frame at the alpha stream's depth", flush=True)
    check(edge_px > 0 and rejected > 0, "the alpha test does work")
    k_counts = stream_counts(pe_a, pa, mv.n_tiles_x, mv.sub, row_skip=True,
                             z=True)
    print(f"kernel K's stream: {k_counts}", flush=True)
    err_l, winners = check_and_time_l(ctx, mv, main, vis_k)

    m_found = check_and_time_m(ctx, mv, main)
    ctx.extra["m_launches"] = m_found["launches"]["expand_rows"]

    # times and bounds from this run's inputs, counting what the data
    # needs: J and K the rows of each live pair that their kernels stage,
    # the masks and the bin ranges. J, in place, reads the atlas texels a
    # passing caster covers and writes those it raises; per (pair, pixel)
    # of its bins 3 edge planes (12 flops), the alpha work on covered
    # pixels not counted (a lower bound). J is timed on a copy of the
    # opaque atlas: merging the same casters again does the same work and
    # leaves it as it is
    staged = 4 * N_STAGED_ALPHA
    j_bytes = (4 * passing + 4 * raised + staged * a_pairs + a.masks.nbytes
               + 8 * a.pairs.tile_count.shape[0])
    j_ops = 12 * a_pairs * a.sub * 16 * raster.TILE_W
    merged = init.clone()
    ctx.kernel("depth_alpha", lambda: raster.rasterize_depth(
        a.edges, a.pairs, a.n_bins_y, atlas.n_bins_x, sub=a.sub,
        alpha_masks=a.masks, init_depth=merged), 20,
        lambda: raster.depth_plain(*j_args, masks=a.masks, init=init), 2,
        (j_bytes / HBM_BYTES_PER_S, j_ops / FP32_OPS_PER_S), 0.0)
    check(torch.equal(merged, depth_j), "kernel J's timed merges are stable")
    del init, merged, depth_j
    n_pix = vis_k.numel()
    k_pairs = int(pa.tile_count.sum())
    k_eval = evaluated_pair_pixels(pe_a, pa, mv.n_tiles_x, mv.sub)
    k_bytes = (8 * n_pix + staged * k_pairs + mv.alpha_masks.nbytes
               + 8 * pa.tile_count.shape[0])
    ctx.kernel("winner_alpha", lambda: raster.rasterize_winner_alpha(
        pe_a, pa, mv.alpha_masks, mv.n_tiles_y, mv.n_tiles_x, mv.sub, True),
        20, lambda: raster.winner_alpha_plain(*k_args), 2,
        (k_bytes / HBM_BYTES_PER_S, 16 * k_eval / FP32_OPS_PER_S), 0.0)
    small = small_card_vs_cpu(ctx, 2, "small banner scene (slice 2 "
                              "settings)", textured=True, banners=True)
    return dict(pair_budget_scale=ctx.scale, **ctx.extra["sdf_bench"],
                atlas_alpha_pairs=a_pairs, atlas_alpha_bins=[
                    a.n_bins_y, atlas.n_bins_x], atlas_texels_raised=raised,
                atlas_texels_rejected=rejected_j,
                atlas_texels_passing=passing, atlas_alpha_stream=j_counts,
                main_alpha_stream=k_counts, main_alpha_pairs=k_pairs,
                main_alpha_winner_triangles=winners,
                main_alpha_edge_pixels=edge_px,
                main_alpha_rejected_pixels=rejected,
                main_alpha_winning_pixels=alpha_wins,
                main_alpha_evaluated_pair_pixels=k_eval,
                carry_table=m_found,
                small_banners_close=small)


def box_objects(atrium: dict) -> tuple:
    """Object indices of the atrium's scattered boxes: after the floor,
    ceiling and 3 walls (5 box_mesh slabs) and each column's shaft and cap
    (assets/procedural.py:build_atrium_scene)."""
    first = 5 + 4 * atrium["columns_per_row"]
    return tuple(range(first, first + atrium["box_count"]))


def box_motions(object_matrices, boxes, frames: int, device):
    """Model matrices of frames -1 .. frames - 1 as one (frames + 1, O, 4,
    4) tensor on `device`, made once before a run: box k of `boxes` at
    frame t is shifted by 0.3 (sin(0.2 t + k), 0, cos(0.2 t + k)) m and
    turned by 0.05 t rad about the vertical axis through its centre; every
    other object keeps its build matrix."""
    build = np.asarray(object_matrices, np.float32)
    out = np.repeat(build[None], frames + 1, axis=0)
    for j, t in enumerate(range(-1, frames)):
        for k, o in enumerate(boxes):
            c = build[o][:3, 3]
            turn = np.eye(4, dtype=np.float32)
            turn[0, 0] = turn[2, 2] = np.cos(0.05 * t)
            turn[0, 2] = np.sin(0.05 * t)
            turn[2, 0] = -np.sin(0.05 * t)
            move, back = np.eye(4, dtype=np.float32), np.eye(4,
                                                             dtype=np.float32)
            move[:3, 3] = c + 0.3 * np.asarray(
                [np.sin(0.2 * t + k), 0.0, np.cos(0.2 * t + k)], np.float32)
            back[:3, 3] = -c
            out[j, o] = move @ turn @ back @ build[o]
    return torch.as_tensor(out, device=device)


def moving_frames(scene, mats) -> list:
    """Per-frame scenes: frame i gets rows i + 1 (its model matrices) and
    i (the previous frame's) of box_motions' tensor, so that a frame
    copies nothing from the host."""
    return [dict(scene, object_transforms=mats[i + 1],
                 prev_object_transforms=mats[i])
            for i in range(mats.shape[0] - 1)]


def dynamic_atrium_scene(ctx) -> list:
    """bench.py's scene (the banner atrium) with its 12 scattered boxes
    dynamic: in the raster (object_transforms, moved every frame by
    box_motions) and in the SDF (build_scene_sdf(dynamic_objects=...)
    baked on the card at bake_resolution_cap=32, attach_dynamic_sdf).
    Returns one scene per camera (moving_frames)."""
    if "banners" not in ctx.scenes:
        ctx.scenes["banners"] = SCENES["banners"](ctx)
    rs, scene_data = ctx.scenes[("source", "banners")]
    boxes = box_objects(BENCH_ATRIUM)
    t0 = time.time()
    gsdf, dset = sdf_scene.build_scene_sdf(
        rs, scene_data, bake_resolution_cap=32, device=ctx.dev,
        dynamic_objects=boxes)
    scene = frame.attach_dynamic_sdf(
        frame.attach_global_sdf(ctx.scenes["banners"], gsdf), dset)
    torch.cuda.synchronize()
    bake_s = time.time() - t0
    windows = [list(w) for w in dset.window_vox]
    print(f"dynamic scene: boxes {boxes[0]}-{boxes[-1]} move; static SDF "
          f"without them baked in {bake_s:.1f} s, grid {scene['sdf_grid']}; "
          f"{len(dset.volumes)} dynamic instances, windows {windows[:2]}...",
          flush=True)
    ctx.extra["sdf_dynamic"] = dict(
        sdf_bake_s=bake_s, sdf_grid=list(scene["sdf_grid"]),
        dynamic_objects=list(boxes), dynamic_windows=windows)
    return moving_frames(scene, box_motions(rs.object_matrices, boxes,
                                            len(ctx.cams), ctx.dev))


def prev_ndc_error(mv, main, prev_view_proj, tri_object, moving):
    """|G-buffer channels 13-14 - static_prev_ndc| (max over x, y) of one
    frame's main view, on the pixels of static objects and on those of
    the moving ones (object indices `moving`): the opaque stream's winners
    by kernel B, the alpha stream's (banners, static) by kernel K."""
    ph, pw = main.depth.shape
    world = shade.reconstruct_world_position(
        main.depth, mathutils.lu_inverse(mv.view_proj), pw, ph)
    err = (main.gbuf[raster._CH_PREV:raster._CH_PREV + 2]
           - frame.static_prev_ndc(prev_view_proj, world, main.vis >= 0)) \
        .abs().amax(dim=0)
    d1, v1, _ = raster.rasterize_gbuffer(
        main.pair_edges, main.pair_attrs, main.pairs, mv.n_tiles_y,
        mv.n_tiles_x, sub=mv.sub, row_skip=True)
    ids = raster.winner_triangle_ids(v1, main.pairs, mv.n_tiles_x, mv.sub)
    obj = torch.where(ids >= 0, tri_object[ids.clamp(min=0).long()], -1)
    if main.alpha_pairs is not None:
        d2, _ = raster.rasterize_winner_alpha(
            main.alpha_edges, main.alpha_pairs, mv.alpha_masks,
            mv.n_tiles_y, mv.n_tiles_x, mv.sub, True)
        obj = torch.where(d2 > d1, -2, obj)  # a banner won
    on_moving = torch.isin(obj, torch.as_tensor(moving, device=obj.device))
    covered = main.vis >= 0
    return err[covered & ~on_moving], err[covered & on_moving]


def slice6_kernels(ctx, frames, settings) -> dict:
    """The dynamic path's new branches on this row's own frame inputs:
    kernel E (timed) and J, exact, on the atlas of the moving casters;
    kernel D under trilinear + anisotropic filtering (the frame's) and
    under trilinear alone; kernels B and L with the 40-row pair table (15
    channels); kernel M at the opaque main view's 56 rows; the previous
    NDC against the static reprojection; the recomposited SDF against
    the pristine one and the CPU recomposite; the small textured atrium
    with a moving box, card vs CPU."""
    print(f"slice 6 settings: default RenderSettings() with "
          f"{settings.shading}; pair_budget_scale {ctx.scale}", flush=True)
    rec = record_frames(ctx, frames, settings, 2, [
        (frame, "raster_main_view"), (texture, "sample_materials"),
        (sdf_scene, "recomposite_dynamic"), (frame, "render_shadow_atlas")])
    # the atlas of frame 0's moving casters: E exact and timed, J exact
    atlas = frame.render_shadow_atlas(*rec["render_shadow_atlas"][0])
    n_cas = settings.shadows.cascade_count
    e_dyn = check_and_time_e(ctx, atlas, n_cas, variant="dynamic casters")
    check_j(atlas, settings, "kernel J (dynamic casters)")
    print("kernel J (dynamic casters): atlas equal", flush=True)
    del atlas
    kw = texture_kwargs(settings)
    check(kw["trilinear"] and kw["aniso"], "texture_filter 2 in the frame")
    targs = rec["sample_materials"][0]
    d_both = check_and_time_d(ctx, frames[0], targs, kw,
                              variant="trilinear+aniso")
    d_tri = check_and_time_d(ctx, frames[0], targs, dict(kw, aniso=False),
                             variant="trilinear")
    mv = rec["raster_main_view"][0][0]
    main = frame.raster_main_view(mv)
    check(int(main.overflow) == 0, "no main-view pairs dropped")
    check(main.pair_attrs.shape[0] == 40 and main.gbuf.shape[0] == 15,
          "the dynamic main view carries 40 attribute rows, 15 channels")
    frac_b, _, _, _ = check_and_time_b(
        ctx, mv, main.pairs, main.pair_edges, main.pair_attrs,
        "kernel B (dynamic)", variant="dynamic 15 channels")
    _, vis_k = raster.rasterize_winner_alpha(
        main.alpha_edges, main.alpha_pairs, mv.alpha_masks, mv.n_tiles_y,
        mv.n_tiles_x, mv.sub, True)
    check_and_time_l(ctx, mv, main, vis_k, variant="dynamic 15 channels")
    m_found = check_and_time_m(ctx, mv, main, variant="dynamic 56 rows")
    ctx.extra["m_variant_launches"] = {"dynamic 56 rows": dict(
        launches=m_found["launches"]["expand_rows"],
        launches_on="build_pairs(carry_table=...), slice 6")}
    check(m_found["rows"] == 56, "kernel M at 16 + 40 rows")

    # previous NDC of frame 1 against the static reprojection of its depth
    mv1 = rec["raster_main_view"][1][0]
    main1 = frame.raster_main_view(mv1)
    rs = ctx.scenes[("source", "banners")][0]
    tri_object = torch.as_tensor(rs.tri_object, device=ctx.dev)
    boxes = box_objects(BENCH_ATRIUM)
    static_err, box_err = prev_ndc_error(mv1, main1, mv.view_proj,
                                         tri_object, boxes)
    static_close = float((static_err <= 1e-4).float().mean())
    box_apart = float((box_err > 1e-3).float().mean()) if box_err.numel() \
        else None
    print(f"previous NDC (frame 1): {static_err.numel()} static-object "
          f"pixels, {static_close:.6f} within 1e-4 of the static "
          f"reprojection (limit 0.999), max {float(static_err.max()):.3e}; "
          f"{box_err.numel()} moving-box pixels, share apart by > 1e-3: "
          f"{box_apart}", flush=True)
    check(static_close >= 0.999, "previous NDC of static objects")

    # the recomposite: fresh copies that differ from the pristine pools,
    # equal to the CPU recomposite of the same inputs
    r_args = rec["recomposite_dynamic"][0]
    vol_k, alb_k = sdf_scene.recomposite_dynamic(*r_args)
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor)
                else [v.cpu() for v in a] if isinstance(a, list) else a
                for a in r_args]
    vol_c, alb_c = sdf_scene.recomposite_dynamic(*cpu_args)
    q_k, q_c = (sdfgi_quanta(v) for v in (vol_k.cpu(), vol_c))
    q_equal = float((q_k == q_c).float().mean())
    q_max = int((q_k - q_c).abs().max())
    alb_equal = float((alb_k.cpu() == alb_c).float().mean())
    changed = int((vol_k != r_args[0]).flatten(1).any(1).sum())
    print(f"recomposite: {changed} of {vol_k.shape[0]} bricks differ from "
          f"the pristine pool; card vs CPU: quanta equal on {q_equal:.6f} "
          f"(limit 0.999), max {q_max} (limit 1), albedo words equal on "
          f"{alb_equal:.6f} (limit 0.999)", flush=True)
    check(changed > 0, "the boxes recomposite into the SDF")
    check(q_equal >= 0.999 and q_max <= 1 and alb_equal >= 0.999,
          "recomposite card vs CPU")
    small = small_card_vs_cpu(ctx, 6, "small dynamic scene (slice 6 "
                              "settings, moving box)", textured=True,
                              gi=True, moving=True, dynamic=True)
    return dict(pair_budget_scale=ctx.scale, **ctx.extra["sdf_dynamic"],
                atlas=e_dyn,
                texture_trilinear_aniso=d_both, texture_trilinear=d_tri,
                gbuffer_pixels_differ=frac_b, carry_table=m_found,
                prev_ndc=dict(static_pixels=static_err.numel(),
                              static_within_1e4=static_close,
                              static_max=float(static_err.max()),
                              box_pixels=box_err.numel(),
                              box_apart_share=box_apart),
                recomposite=dict(bricks_changed=changed,
                                 quanta_equal=q_equal, quanta_max=q_max,
                                 albedo_equal=alb_equal),
                small_close=small)


def sdfgi_quanta(words):
    """The s8 distance quanta of packed (NB, 8, 128) SDF words."""
    q = torch.stack([(words >> (8 * b)) & 0xFF for b in range(4)], dim=-1)
    return torch.where(q > 127, q - 256, q)


# ------------------------- checks after a run -------------------------

def _one_frame(ctx, frames, run, settings):
    """One more frame from the run's last state and the last camera."""
    return frame.render_frame(run["state"], frames[-1], ctx.cams[-1],
                              ctx.luts, 1.0 / 60.0, settings,
                              device=ctx.dev)[0]


def slice4_after(ctx, frames, settings, run) -> dict:
    """One frame with fog off and one with bloom off, from the run's last
    state, differ from the full frame; then profile_frames."""
    def one(s):
        return _one_frame(ctx, frames, run, s)
    full, differ = one(settings), {}
    for name, field, off in (
            ("fog", "volumetrics", config.VolumetricsSettings(enabled=False)),
            ("bloom", "bloom", config.BloomSettings(enabled=False))):
        img = one(dataclasses.replace(settings, **{field: off}))
        differ[name] = float((img != full).any(dim=-1).float().mean())
        print(f"slice 4 with {name} off: {differ[name]:.4f} of pixels "
              "differ from the full frame", flush=True)
        check(differ[name] > 0.0, f"the {name} pass changes the frame")
    return dict(pixels_differ_when_off=differ,
                **profile_frames(ctx, frames, settings, run, "slice 4"))


def profile_frames(ctx, frames, settings, run, what: str) -> dict:
    """2 more frames under torch.profiler: device busy share and kernels
    per frame (the profiler's own host cost is in the window, so the share
    is a lower bound). Device kernels are the events with device time; the
    others are the host's CUDA runtime calls (a cudaLaunchKernel per
    kernel), counted apart."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            _one_frame(ctx, frames, run, settings)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_kernel = sorted(
        ((e.key, getattr(e, "self_device_time_total", 0.0), e.count)
         for e in prof.key_averages()), key=lambda k: -k[1])
    device_us = sum(t for _, t, _ in by_kernel)
    device_launches = sum(n for _, t, n in by_kernel if t > 0) / 2
    other = sum(n for _, t, n in by_kernel if t <= 0) / 2
    busy = device_us / window_us if device_us > 0 else None
    print(f"profiler ({what}): device busy {device_us / 2e3:.2f} ms/frame "
          f"of {window_us / 2e3:.2f} ms wall -> busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'}; "
          f"{device_launches:.0f} device kernels/frame under "
          f"{sum(t > 0 for _, t, _ in by_kernel)} names, {other:.0f} host "
          "runtime events/frame", flush=True)
    return dict(busy_share=busy, profiled_device_us_per_frame=device_us / 2,
                device_kernels_per_frame=device_launches,
                runtime_events_per_frame=other,
                profiled_wall_us_per_frame=window_us / 2,
                top_kernels_us_per_frame=[(k, t / 2, n / 2)
                                          for k, t, n in by_kernel[:30]])


def flight_phase(ctx, frames, settings, run, per_frame: dict) -> dict:
    """render_flight over the same frames as the row's eager run (the same
    initial state, scene, camera path and settings; frame 1 eager, then one
    captured frame step replayed): launch counts reset just before, read
    just after, per_frame times the frames for the path's kernels and 0
    for the others; the last image and every state field bit-equal to the
    eager camera-path run's. Then, on the flight's final state, one
    FrameGraph: its capture time, REPLAYS replays between CUDA events
    (device ms per frame) and on the host clock to their end, and
    PROFILED replays under torch.profiler (busy share, device kernels per
    replay)."""
    n = run["frames"]
    state0 = initial_state(settings.width, settings.height, device=ctx.dev)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    image, state = frame.render_flight(state0, frames[0], ctx.cam_path,
                                       ctx.luts, 1.0 / 60.0, settings, n,
                                       device=ctx.dev)
    torch.cuda.synchronize()
    flight_s = time.perf_counter() - t0
    launches = native.launch_counts()
    print(f"flight: {n} frames in {flight_s:.3f} s (frame 1 eager, capture, "
          f"{n - 1} replays); launches {launches}", flush=True)
    for name in KERNEL_SOURCES:
        want = per_frame.get(name, 0) * n
        check(launches[name] == want,
              f"flight: kernel {name} launched {launches[name]}x, want {want}")
    fields = [f.name for f in dataclasses.fields(state)]
    differ = [k for k in fields
              if not same_bits(getattr(state, k), getattr(run["state"], k))]
    image_equal = same_bits(image, run["image"])
    print(f"flight vs the eager camera-path run: image bits equal "
          f"{image_equal}, state fields differing {differ}", flush=True)
    check(image_equal and not differ, "flight equals the eager frames")
    del image, state0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = frame.FrameGraph(state, frames[0], ctx.cam_path, ctx.luts,
                            1.0 / 60.0, settings)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    step.replay()  # the first replay after capture uploads the graph
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    step.replay(FLIGHT_REPLAYS)
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / FLIGHT_REPLAYS
    device_ms = start.elapsed_time(end) / FLIGHT_REPLAYS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.replay(FLIGHT_PROFILED)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_kernel = [(getattr(e, "self_device_time_total", 0.0), e.count)
                 for e in prof.key_averages()]
    busy_us = sum(t for t, _ in by_kernel)
    kernels = sum(c for t, c in by_kernel if t > 0) / FLIGHT_PROFILED
    busy = busy_us / window_us if busy_us > 0 else None
    per_replay = sum(step.launches.values())
    eager = run["pass_ms"]
    print(f"flight (slice 5): replayed frames {device_ms:.3f} ms/frame "
          f"(CUDA events over {FLIGHT_REPLAYS} replays), {wall_ms:.3f} "
          f"ms/frame host wall (enqueue {enqueue_ms:.3f} ms for all); "
          f"capture {capture_s * 1e3:.1f} ms; {per_replay} hand-written "
          f"kernel launches per replay {step.launches}; profiler over "
          f"{FLIGHT_PROFILED} replays: busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'}, "
          f"{busy_us / FLIGHT_PROFILED / 1e3:.2f} ms of device work in "
          f"{kernels:.0f} device kernels per replay", flush=True)
    print(f"flight (slice 5) beside the eager frame: eager "
          f"{eager['frame']['mean']:.3f} ms/frame (events), "
          f"{eager['host_wall_per_frame']['mean']:.3f} ms host wall; "
          f"replayed {device_ms:.3f} ms (events), {wall_ms:.3f} ms host "
          "wall", flush=True)
    found = dict(frames=n, flight_s=flight_s, launches=launches,
                 equal_to_eager=True, capture_s=capture_s,
                 replays=FLIGHT_REPLAYS, replay_ms_per_frame=device_ms,
                 replay_host_wall_ms_per_frame=wall_ms,
                 replay_enqueue_ms=enqueue_ms,
                 launches_per_replay=per_replay,
                 kernel_launches_per_replay=dict(step.launches),
                 profiled_replays=FLIGHT_PROFILED, busy_share=busy,
                 device_us_per_replay=busy_us / FLIGHT_PROFILED,
                 device_kernels_per_replay=kernels,
                 eager_frame_ms=eager["frame"]["mean"],
                 eager_host_wall_ms=eager["host_wall_per_frame"]["mean"])
    del step
    torch.cuda.empty_cache()
    return found


def slice5_after(ctx, frames, settings, run) -> dict:
    """profile_frames of the eager run, then flight_phase."""
    found = profile_frames(ctx, frames, settings, run, "slice 5")
    found["flight"] = flight_phase(ctx, frames, settings, run, _BENCH)
    return found


# one slice of the port: its settings, scene, frames, the kernels it
# launches per frame (the others must stay at 0), the comparisons of its
# new kernels, the checks after its main-path run and the kernels whose
# frames launch a variant (kernel name -> variant) in place of the default
Row = collections.namedtuple(
    "Row", "n scene warmup timed per_frame kernels after "
    "pick_scale histories branches", defaults=(None, False, {}, {}))


_A_TO_F = {"expand_keys": 2, "gbuffer": 1, "material": 1, "texture": 1,
           "depth": 1, "shadow": 1}
_A_TO_I = dict(_A_TO_F, sdfgi_trace=1, packed_planes=1, history_taps=1)
_HISTORIES = dict(gi_history=taa.unpack_f16_pair,
                  taa_history=color_packing.unpack_r11g11b10)
# bench.py's scene: A for both streams of the main view and of the atlas;
# M stays at 0 on the frame (its own path: slice5_kernels)
_BENCH = dict(_A_TO_I, expand_keys=4, depth_alpha=1, winner_alpha=1,
              attr_resolve=1)
SLICES = [
    Row(1, "untextured", 1, 3,
        {"expand_keys": 1, "gbuffer": 1, "material": 1}, slice1_kernels),
    Row(2, "textured", 1, 3, _A_TO_F,
        slice2_kernels, pick_scale=True),
    Row(3, "sdf", 3, 8,
        dict(_A_TO_F, sdfgi_trace=1, packed_planes=1), slice3_kernels,
        histories=dict(gi_history=taa.unpack_f16_pair)),
    Row(4, "sdf", 3, 8, _A_TO_I, slice4_kernels, slice4_after,
        histories=_HISTORIES),
    # bench.py's own scene; after its run, the same frames as a flight
    # (render_flight)
    Row(5, "bench", 3, 8, _BENCH, slice5_kernels, slice5_after,
        pick_scale=True, histories=_HISTORIES),
    # the same scene with its 12 boxes moving (raster and SDF) and
    # texture_filter 2: B and L write 15 channels, D runs its trilinear +
    # anisotropic branch, the SDF is recomposited every frame
    Row(6, "bench_dynamic", 3, 8, _BENCH, slice6_kernels,
        lambda ctx, frames, settings, run: profile_frames(
            ctx, frames, settings, run, "slice 6"),
        pick_scale=True, histories=_HISTORIES,
        branches=dict(depth="dynamic casters",
                      gbuffer="dynamic 15 channels",
                      attr_resolve="dynamic 15 channels",
                      texture="trilinear+aniso")),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "measures the GPU port and has no CPU mode", file=sys.stderr)
        return 2
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
    ctx = Ctx(torch.device("cuda"))
    ctx.report["card"] = smi
    t_start = t0 = time.time()
    lib_path = native.build()
    native.library()
    ctx.report["build_s"] = time.time() - t0
    print(f"build: {ctx.report['build_s']:.1f} s -> {lib_path}", flush=True)
    (OUT / "ptxas.log").write_text(
        (lib_path.parent / "ptxas.log").read_text()
        if (lib_path.parent / "ptxas.log").exists() else "cached build\n")
    ctx.luts = frame.bake_static_luts(config.RenderSettings(), device=ctx.dev)
    exts = [cam_mod.extrinsic_from_angles(  # bench.py:105-110's path
        [-9.0 + 0.02 * t, -1.8, 0.3 * np.sin(t * 0.05)], pitch_deg=8.0,
        yaw_deg=10.0 + t * 0.1)
        for t in range(max(r.warmup + r.timed for r in SLICES))]
    ctx.cams = [frame.camera_arrays(e.position, e.forward, e.right, e.up,
                                    device=ctx.dev) for e in exts]
    ctx.cam_path = frame.camera_arrays(  # bench.py:114-115: one upload
        *(np.stack([getattr(e, k) for e in exts])
          for k in ("position", "forward", "right", "up")), device=ctx.dev)
    row_launches = {}
    for row in SLICES:
        if row.scene not in ctx.scenes:
            ctx.scenes[row.scene] = SCENES[row.scene](ctx)
        scene = ctx.scenes[row.scene]
        frames = scene if isinstance(scene, list) \
            else [scene] * len(ctx.cams)
        if row.pick_scale:
            ctx.scale = pick_pair_budget_scale(ctx, frames, row)
        settings = dataclasses.replace(slice_settings(row.n, WIDTH, HEIGHT),
                                       pair_budget_scale=ctx.scale)
        ctx.path = f"slice {row.n} ({row.scene} scene)"
        found = row.kernels(ctx, frames, settings)
        run = drive(ctx, frames, settings, row.warmup, row.timed)
        row_launches[row.n] = run["launches"]
        found.update(check_run(run, row, f"slice {row.n}"))
        if row.after is not None:
            found.update(row.after(ctx, frames, settings, run))
        ctx.report[f"slice{row.n}"] = found
        if row.scene == "untextured":
            del ctx.scenes["untextured"]
        torch.cuda.empty_cache()
    def launched(name, variant=None):
        """The launches of the last row whose frames run this branch."""
        rows = [r.n for r in SLICES if r.branches.get(name) == variant]
        if not rows:
            return dict(launches=0, launches_on="no render_frame row")
        return dict(launches=row_launches[rows[-1]][name],
                    launches_on=f"render_frame, slice {rows[-1]}")
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        entry = {
            "name": name, "route": "cuda",
            "source": "plainrenderer_tpu_torch/csrc/" + source,
            "replaces": "plainrenderer_tpu/ops/" + replaces,
            **launched(name), **ctx.results[name]}
        if name in ctx.variants:  # other branches of the same kernel
            entry["variants"] = [dict(variant=v, **launched(name, v), **r)
                                 for v, r in ctx.variants[name].items()]
        if name in ctx.earlier:  # its times on earlier rows' inputs
            entry["earlier"] = ctx.earlier[name]
        if name == "expand_keys":  # its second use: the atlas's keys
            entry.update(ctx.extra["atlas_keys"])
        if name == "expand_rows":  # not on the frame: its own path
            entry.update(launches=ctx.extra["m_launches"],
                         launches_on="build_pairs(carry_table=...)",
                         frame_launches=run["launches"][name])
            for v in entry.get("variants", ()):
                v.update(ctx.extra["m_variant_launches"][v["variant"]])
        kernels.append(entry)
    ctx.report.update(kernels=kernels, total_s=time.time() - t_start)
    (OUT / "report.json").write_text(json.dumps(ctx.report, indent=1))
    print(f"total {ctx.report['total_s']:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
