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
rows; the previous NDC, the recomposited SDF); 7 slice 5's scene with the
TAA supersampling pre-pass (I at K = 1 on the previous frame's packed
colour and H at P = 1 on its (luminance, linear depth) pair, beside their
default uses; after its run the same frames as a flight). After the
rows, the runtime phase runs the port's App on the committed courtyard demo
(assets/demo/courtyard.plain) as runtime/app.main() sets it up at
1920x1080: its DDS volumes and textures loaded, kernels A-L held to
their plain versions on its frames' inputs, timed run_frames (each step
timed: run_frame, the copy to the host, burn_stats, save_image), the
debug views, a small App card vs CPU, and the command line in
subprocesses (runtime_phase). Then the modules phase: the Monte Carlo BRDF
bake for each diffuse BRDF on the card (timed, its peak memory; against
the CPU's plain bake and the fitted polynomials) and the committed JPEG
fixtures decoded equal to PIL's PNGs (modules_phase). Then the formats
phase: the committed fixtures of tests/data/formats (BMP, DIB, TGA, PNM,
GIF, TIFF, WebP, JPEG, PSD, QOI, SGI, PCX / DCX, ICO / CUR) decoded
equal to PIL's PNGs beside them, timed on the host; then the courtyard
with its 12 textures re-saved by the port's save_image as TGA, TIFF, QOI
and SGI, and with its four RGB normal maps as BMP and PPM, each loaded
by the App at 1920x1080 (all 12 texture slots in the pool) and rendered
for 3 frames, its texture pool and frames equal bit for bit to the
committed PNG courtyard's; and with those four maps written as JPEG,
their bytes PIL's (SHA-256), loaded and rendered (formats_phase). Then row 8, the band phase: split-frame band mode on 4 ranks sharing the one card over
gloo (collectives staged through the host, counted), bench.py's scene at
1920x1024 (band_settings' frame for 1920x1080 and 4 bands) in 256-row
bands, 3 frames against the parent's single-device render of the same
frames (seams included), each rank's counters, launches, frame ms,
collectives, host copies and syncs and peak memory, A, B, E, J, K and L
held to their plain versions on rank 1's band (timed as the variant
"band (rank 1 of 4)" while the other ranks wait), and a small band frame
on card ranks against CPU ranks (band_phase). It measures correctness
and the collectives' cost of ranks that share a card, not a speed-up
across cards. Each row
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
import contextlib
import dataclasses
import hashlib
import json
import shutil
import struct
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from plainrenderer_tpu_torch import config, native
from plainrenderer_tpu_torch.assets import image_io, procedural
from plainrenderer_tpu_torch.assets.textures import MAX_MIPS
from plainrenderer_tpu_torch.ops import (brdf_lut, color_packing,
                                         env_brdf_fit, post, raster,
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
    filtering (texture_filter 2); 7 the defaults with the TAA
    supersampling pre-pass (taa.use_separate_supersampling); 3 without
    TAA, bloom and fog; 2 also without GI; 1 also without shadows."""
    off = dict(enabled=False)
    drop = dict(taa=config.TAASettings(**off),
                bloom=config.BloomSettings(**off),
                volumetrics=config.VolumetricsSettings(**off)) if n <= 3 else {}
    if n == 6:
        drop["shading"] = config.ShadingConfig(texture_filter=2)
    if n == 7:
        drop["taa"] = config.TAASettings(use_separate_supersampling=True)
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
        # set while a phase times kernels on its own inputs: their results
        # go under this variant name beside the rows' own
        self.tag = None

    def result(self, name, variant=None) -> dict:
        """The record that kernel() last stored for name (and variant, or
        the phase's tag)."""
        variant = variant if variant is not None else self.tag
        return self.results[name] if variant is None \
            else self.variants[name][variant]

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
        variant = variant if variant is not None else self.tag
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
    result = ctx.result("gbuffer", variant)
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
    result = ctx.result("texture", variant)
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
    result = ctx.result("depth", variant)
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
    ctx.result("shadow").update(
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


@contextlib.contextmanager
def recorded_calls(targets):
    """Within the block, each (module, name) in targets is wrapped to
    record its positional arguments, in call order; yields name -> list."""
    recorded = {name: [] for _, name in targets}
    originals = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def recorder(fn, seen):
        return lambda *args, **kw: (seen.append(args), fn(*args, **kw))[1]
    for mod, name, fn in originals:
        setattr(mod, name, recorder(fn, recorded[name]))
    try:
        yield recorded
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def record_frames(ctx, frames, settings, n: int, targets):
    """Render the first n of the per-frame scenes from a fresh state with
    each (module, name) in targets recorded (recorded_calls)."""
    with recorded_calls(targets) as recorded:
        state = initial_state(WIDTH, HEIGHT, device=ctx.dev)
        for i in range(n):
            _, state = frame.render_frame(
                state, frames[i], ctx.cams[i], ctx.luts, 1.0 / 60.0,
                settings, device=ctx.dev)
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


# the calls whose arguments check_a_to_i reads (frames 0 and 1)
A_TO_I_CALLS = [
    (frame, "raster_main_view"), (frame, "render_shadow_atlas"),
    (texture, "sample_materials"), (shadow, "shadow_resolve"),
    (frame, "trace_scene_gi"), (taa, "resample_packed_planes"),
    (taa, "history_coords"), (taa, "resample_history_taps"),
    (raster, "expand_keys")]


def retime_a_to_i(ctx, frames, settings):
    """Kernels A-I again, each checked against its plain version (A on all
    four of frame 0's streams) and timed on this row's own frame inputs
    (frames 0 and 1, recorded on their way into the kernels), so that the
    kernels line's timed_on names this row;
    the earlier rows' times stay under `earlier`. Returns the recorded
    calls."""
    rec = record_frames(ctx, frames, settings, 2, A_TO_I_CALLS)
    check_a_to_i(ctx, rec, frames[0], settings)
    return rec


def check_a_to_i(ctx, rec, scene, settings, atlas_time=True):
    """check_and_time_* of kernels A-I on recorded frames 0 and 1 of one
    scene (A_TO_I_CALLS); atlas_time False checks the atlas's keys without
    timing them."""
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
    check_and_time_c(ctx, scene, main.gbuf, main.vis)
    targs = rec["sample_materials"][0]
    check_and_time_d(ctx, scene, targs, texture_kwargs(settings))
    atlas = frame.render_shadow_atlas(*rec["render_shadow_atlas"][0])
    ki2, _, atlas_bound = atlas_keys(atlas, settings,
                                     "kernel A (atlas, opaque casters)")
    if atlas_time:
        time_keys(ctx, atlas_ki=ki2, atlas_bound=atlas_bound)
    check_and_time_e(ctx, atlas, settings.shadows.cascade_count)
    check_and_time_f(ctx, atlas, rec["shadow_resolve"][0], settings,
                     targs[3])
    check_and_time_g(ctx, rec["trace_scene_gi"][0])
    check_and_time_h(ctx, rec["resample_packed_planes"][1])
    check_and_time_i(ctx, rec["history_coords"][1],
                     rec["resample_history_taps"][1][0])


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
    n_cas, sres = settings.shadows.cascade_count, settings.shadows.resolution
    # the frame's atlas rows this call rasterized: all of them, or in band
    # mode the band's (its ceil-padded tail past the atlas cut)
    r0 = 0 if atlas.view_row0 is None \
        else atlas.view_row0 * atlas.sub * raster.TILE_H
    rows = min(atlas.n_bins_y * atlas.sub * raster.TILE_H, n_cas * sres - r0)
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
    check(torch.equal(depth_j[:rows],
                      atlas.maps[:n_cas].reshape(-1, sres)[r0:r0 + rows]),
          f"{what}'s result is the frame's atlas")
    return depth_j, init, j_args


def check_and_time_jkl(ctx, rec, settings, what: str = "", atlas=None,
                       mv=None, variant=None) -> dict:
    """Kernels J, K and L on recorded frame 0's alpha streams (the
    atlas's and the main view's, recomputed from the recorded inputs of
    the frame's own calls, or given: atlas, the frame's ShadowAtlas, and
    mv, its MainView): J exact and equal to the frame's atlas (check_j),
    K's depth and vis exact, L by check_and_time_l; the alpha test's
    work; J and K timed with bounds from this run's inputs (as
    `variant`). Returns the stats, and the main view's setup and raster
    under "mv" and "main"."""
    if atlas is None:
        atlas = frame.render_shadow_atlas(*rec["render_shadow_atlas"][0])
    a = atlas.alpha
    depth_j, init, j_args = check_j(atlas, settings, f"kernel J{what}")
    uncut_j = raster.depth_plain(*j_args, init=init)
    raised = int((depth_j > init).sum())
    rejected_j = int((uncut_j > depth_j).sum())
    # texels a caster covers and passes: those J reads (and writes if
    # raised)
    passing = int((raster.depth_plain(*j_args, masks=a.masks) > 0).sum())
    a_pairs = int(a.pairs.tile_count.sum())
    print(f"kernel J{what}: {a_pairs} alpha caster pairs in {a.n_bins_y} x "
          f"{atlas.n_bins_x} bins of {a.sub * 16} rows; atlas equal; "
          f"{passing} texels covered by a passing caster, {raised} raised "
          f"over the opaque atlas, {rejected_j} where the masks rejected "
          "every covering caster", flush=True)
    del uncut_j
    j_counts = stream_counts(a.edges, a.pairs, atlas.n_bins_x, a.sub,
                             row_skip=False, z=False)
    print(f"kernel J's stream{what}: {j_counts}", flush=True)

    if mv is None:
        mv = rec["raster_main_view"][0][0]
    main = frame.raster_main_view(mv)
    check(int(main.overflow) == 0, f"no main-view pairs dropped{what}")
    pa, pe_a = main.alpha_pairs, main.alpha_edges
    k_args = (pe_a, pa.tile_start, pa.tile_count, mv.alpha_masks,
              mv.n_tiles_y, mv.n_tiles_x, mv.sub, True)
    depth_k, vis_k = raster.rasterize_winner_alpha(
        pe_a, pa, mv.alpha_masks, mv.n_tiles_y, mv.n_tiles_x, mv.sub, True)
    depth_kp, vis_kp = raster.winner_alpha_plain(*k_args)
    check(torch.equal(depth_k, depth_kp) and torch.equal(vis_k, vis_kp),
          f"kernel K{what} depth and vis equal the plain version")
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
    print(f"kernel K{what}: {int(pa.tile_count.sum())} alpha pairs; depth "
          f"and vis equal; the alpha stream's edges cover {edge_px} pixels, "
          f"the masks reject {rejected} of them; {alpha_wins} pixels of "
          "the merged frame at the alpha stream's depth", flush=True)
    k_counts = stream_counts(pe_a, pa, mv.n_tiles_x, mv.sub, row_skip=True,
                             z=True)
    print(f"kernel K's stream{what}: {k_counts}", flush=True)
    err_l, winners = check_and_time_l(ctx, mv, main, vis_k, variant)

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
        (j_bytes / HBM_BYTES_PER_S, j_ops / FP32_OPS_PER_S), 0.0,
        variant=variant)
    check(torch.equal(merged, depth_j),
          f"kernel J{what}'s timed merges are stable")
    del init, merged, depth_j
    n_pix = vis_k.numel()
    k_pairs = int(pa.tile_count.sum())
    k_eval = evaluated_pair_pixels(pe_a, pa, mv.n_tiles_x, mv.sub)
    k_bytes = (8 * n_pix + staged * k_pairs + mv.alpha_masks.nbytes
               + 8 * pa.tile_count.shape[0])
    ctx.kernel("winner_alpha", lambda: raster.rasterize_winner_alpha(
        pe_a, pa, mv.alpha_masks, mv.n_tiles_y, mv.n_tiles_x, mv.sub, True),
        20, lambda: raster.winner_alpha_plain(*k_args), 2,
        (k_bytes / HBM_BYTES_PER_S, 16 * k_eval / FP32_OPS_PER_S), 0.0,
        variant=variant)
    return dict(atlas_alpha_pairs=a_pairs, atlas_alpha_bins=[
                    a.n_bins_y, atlas.n_bins_x], atlas_texels_raised=raised,
                atlas_texels_rejected=rejected_j,
                atlas_texels_passing=passing, atlas_alpha_stream=j_counts,
                main_alpha_stream=k_counts, main_alpha_pairs=k_pairs,
                main_alpha_winner_triangles=winners,
                main_alpha_edge_pixels=edge_px,
                main_alpha_rejected_pixels=rejected,
                main_alpha_winning_pixels=alpha_wins,
                main_alpha_evaluated_pair_pixels=k_eval,
                attr_resolve_err=err_l, mv=mv, main=main)


def slice5_kernels(ctx, frames, settings) -> dict:
    """Kernels A-I again on this row's frame inputs (retime_a_to_i), then
    kernels J, K and L on frame 0's alpha streams (check_and_time_jkl),
    the alpha test's work, kernel M in a phase of its own on the frame's
    main-view setup, and the small banner scene card vs CPU."""
    print(f"slice 5 settings: default RenderSettings(); pair_budget_scale "
          f"{ctx.scale}", flush=True)
    rec = retime_a_to_i(ctx, frames, settings)
    found = check_and_time_jkl(ctx, rec, settings)
    mv, main = found.pop("mv"), found.pop("main")
    check(found["atlas_texels_raised"] > 0
          and found["atlas_texels_rejected"] > 0,
          "the alpha casters write and cut")
    check(found["main_alpha_edge_pixels"] > 0
          and found["main_alpha_rejected_pixels"] > 0,
          "the alpha test does work")
    m_found = check_and_time_m(ctx, mv, main)
    ctx.extra["m_launches"] = m_found["launches"]["expand_rows"]
    small = small_card_vs_cpu(ctx, 2, "small banner scene (slice 2 "
                              "settings)", textured=True, banners=True)
    return dict(pair_budget_scale=ctx.scale, **ctx.extra["sdf_bench"],
                **found, carry_table=m_found, small_banners_close=small)


PRE_PASS_I, PRE_PASS_H = "pre-pass K=1", "pre-pass P=1"


def slice7_kernels(ctx, frames, settings) -> dict:
    """Kernels I and H on the supersampling pre-pass's inputs of frame 1
    (the previous frame's packed colour, K = 1; its (luminance, linear
    depth) pair, P = 1; the dilated motion on the 32-row halo), recorded
    on their way into history_resample and the one-plane
    resample_packed_planes: I within 1e-6 of the taps' magnitude, H every
    bit, ok equal on both (compare_history); timed as the variants
    PRE_PASS_I and PRE_PASS_H with bounds from this run's bytes (I: 8 B of
    coords, 4 B of colour read, 3 f32 and ok written per pixel; H: 8 + 4
    read, 2 f32 and ok written) and a grid_sample yardstick each. Then the
    small textured atrium with GI and the pre-pass, card vs CPU over 3
    frames of a moving camera."""
    print(f"slice 7 settings: {settings.taa}; pair_budget_scale "
          f"{ctx.scale}", flush=True)
    rec = record_frames(ctx, frames, settings, 2,
                        [(taa, "history_resample"),
                         (taa, "resample_packed_planes")])
    colour, motion, width, height = rec["history_resample"][1]
    pairs = [a for a in rec["resample_packed_planes"] if a[0].shape[0] == 1]
    check(len(rec["history_resample"]) == 2 and len(pairs) == 2,
          "the pre-pass fetched once a frame")
    planes, motion_h, width_h, height_h = pairs[1]
    check(torch.equal(motion_h, motion) and (width_h, height_h)
          == (width, height), "the pre-pass's two fetches share the motion")
    coords = taa.reprojected_coords(motion, width, height)
    hh, hw = colour.shape
    out_p = taa.history_taps_plain(colour, coords)
    err_i, ok_i = compare_history(f"kernel I ({PRE_PASS_I})", colour, 3,
                                  taa.history_taps(colour, coords), out_p,
                                  out_p)
    del out_p
    err_h, ok_h = compare_history(
        f"kernel H ({PRE_PASS_H})", planes, 2,
        taa.packed_planes(planes, coords),
        taa.packed_planes_plain(planes, coords))
    ctx.kernel("history_taps", lambda: taa.history_taps(colour, coords), 50,
               lambda: taa.history_taps_plain(colour, coords), 10,
               (28 * hh * hw / HBM_BYTES_PER_S, 0.0), err_i,
               grid_sample(color_packing.unpack_r11g11b10(colour)[None],
                           coords), variant=PRE_PASS_I)
    unpacked = torch.stack(taa.unpack_f16_pair_flush(planes[0]))[None]
    ctx.kernel("packed_planes", lambda: taa.packed_planes(planes, coords),
               50, lambda: taa.packed_planes_plain(planes, coords), 10,
               (24 * hh * hw / HBM_BYTES_PER_S, 0.0), err_h,
               grid_sample(unpacked, coords), variant=PRE_PASS_H)
    small = small_card_vs_cpu(ctx, 7, "small atrium with GI and the "
                              "pre-pass", textured=True, gi=True,
                              moving=True)
    return dict(pair_budget_scale=ctx.scale, pre_pass_planes=[hh, hw],
                pre_pass_i=dict(max_abs_err=err_i, ok_share=ok_i),
                pre_pass_h=dict(max_abs_err=err_h, ok_share=ok_h),
                small_close=small)


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


def profile_frames(ctx, frames, settings, run, what: str,
                   step=None) -> dict:
    """2 more frames under torch.profiler (one more frame from the run's
    last state, or step()): device busy share and kernels per frame (the
    profiler's own host cost is in the window, so the share is a lower
    bound). Device kernels are the events with device time; the others
    are the host's CUDA runtime calls (a cudaLaunchKernel per kernel),
    counted apart."""
    step = step or (lambda: _one_frame(ctx, frames, run, settings))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
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


def flight_phase(ctx, frames, settings, run, per_frame: dict,
                 what: str = "slice 5") -> dict:
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
    print(f"flight ({what}): {n} frames in {flight_s:.3f} s (frame 1 eager, capture, "
          f"{n - 1} replays); launches {launches}", flush=True)
    for name in KERNEL_SOURCES:
        want = per_frame.get(name, 0) * n
        check(launches[name] == want,
              f"flight: kernel {name} launched {launches[name]}x, want {want}")
    fields = [f.name for f in dataclasses.fields(state)]
    differ = [k for k in fields
              if not same_bits(getattr(state, k), getattr(run["state"], k))]
    image_equal = same_bits(image, run["image"])
    print(f"flight ({what}) vs the eager camera-path run: image bits equal "
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
    print(f"flight ({what}): replayed frames {device_ms:.3f} ms/frame "
          f"(CUDA events over {FLIGHT_REPLAYS} replays), {wall_ms:.3f} "
          f"ms/frame host wall (enqueue {enqueue_ms:.3f} ms for all); "
          f"capture {capture_s * 1e3:.1f} ms; {per_replay} hand-written "
          f"kernel launches per replay {step.launches}; profiler over "
          f"{FLIGHT_PROFILED} replays: busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'}, "
          f"{busy_us / FLIGHT_PROFILED / 1e3:.2f} ms of device work in "
          f"{kernels:.0f} device kernels per replay", flush=True)
    print(f"flight ({what}) beside the eager frame: eager "
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


# ---------------------------- the runtime ----------------------------

# the committed real-asset demo (assets/demo): its texture and SDF paths
# are relative to the repository root
COURTYARD = "assets/demo/courtyard.plain"
RUNTIME_WARMUP, RUNTIME_TIMED = 3, 8
RUNTIME_OUT = "chiprun_out/runtime"
FORBIDDEN = ("jax", "jaxlib", "plainrenderer_tpu")


def runtime_app(device, width, height, demo=False, scene_path=COURTYARD):
    """The port's App on the courtyard (scene_path: a .plain of it). At
    1920x1080: the settings, camera and SDF cap that runtime/app.main()
    builds from its default flags (the default RenderSettings() with GI
    on, pair_budget_scale 1.0, escalation on). demo:
    tests/test_demo_asset.py's settings and camera at width x height,
    with a fixed delta time."""
    from plainrenderer_tpu_torch.runtime.app import App

    if demo:
        settings = config.RenderSettings(
            width=width, height=height,
            sdf_trace=config.SDFTraceSettings(enabled=True, trace_steps=8),
            volumetrics=config.VolumetricsSettings(enabled=False),
            shadows=config.ShadowSettings(resolution=512),
            exposure_adaption_speed=1000.0)
    else:
        settings = config.RenderSettings(
            width=width, height=height,
            sdf_trace=config.SDFTraceSettings(enabled=True))
    app = App(settings, scene_path, with_gi=True, sdf_resolution_cap=32,
              device=device)
    if demo:
        lo = app.scene["object_bb_min"].cpu().numpy().min(0)
        hi = app.scene["object_bb_max"].cpu().numpy().max(0)
        center = (lo + hi) * 0.5
        app.camera.position = np.asarray(
            [lo[0] - 0.6 * (hi[0] - lo[0]), center[1], center[2]],
            np.float32)
        app.camera.yaw, app.camera.pitch = 0.0, 0.0
        app.timer = types.SimpleNamespace(mark_new_frame=lambda: None,
                                          delta_time=1.0 / 60.0)
    else:  # main()'s --cam, --yaw and --pitch defaults
        app.camera.position = np.asarray([-9.0, -1.8, 0.0], np.float32)
        app.camera.yaw, app.camera.pitch = 10.0, 8.0
    return app


def orbit_input(app):
    """main()'s orbit: mouse-look of --orbit-speed 20 x the last frame's
    delta time (app.py:395)."""
    from plainrenderer_tpu_torch.runtime.shell import InputState

    return InputState(right_mouse_down=True,
                      mouse_movement=(20.0 * app.timer.delta_time, 0.0))


def debug_view_settings(base):
    """The three debug views as settings: the AABB wireframes, the
    cascade tint and SDF visualisation modes 1-4."""
    views = {"draw_bounding_boxes": dataclasses.replace(
                 base, draw_bounding_boxes=True),
             "shadows.debug_cascade_colors": dataclasses.replace(
                 base, shadows=dataclasses.replace(
                     base.shadows, debug_cascade_colors=True))}
    for mode in (1, 2, 3, 4):
        views[f"sdf_debug.visualisation_mode={mode}"] = dataclasses.replace(
            base, sdf_debug=config.SDFDebugSettings(mode))
    return views


def fresh_frame(app, settings):
    """One frame of settings from a fresh state with the app's scene, LUTs
    and current camera (app.state is left alone); the u8 image on the
    host."""
    from plainrenderer_tpu_torch.runtime.shell import InputState

    cam = app._camera(app.camera.update(InputState(), 0.0))
    state = initial_state(settings.width, settings.height,
                          gi_half_res=settings.sdf_trace.half_resolution,
                          device=app.device)
    return frame.render_frame(state, app.scene, cam, app.luts, 1.0 / 60.0,
                              settings, device=app.device)[0].cpu().numpy()


def courtyard_textures_reach_the_pool(app, scene_path=COURTYARD) -> int:
    """Every mesh's albedo, normal and specular file loads with the port's
    own readers, and every object samples a pool texture."""
    from plainrenderer_tpu_torch.assets.plain_format import \
        load_binary_scene

    meshes = load_binary_scene(scene_path).meshes
    for i, mesh in enumerate(meshes):
        images = scenebuild._load_texture_images(mesh.texture_paths)
        for slot in ("albedo", "normal", "specular"):
            check(getattr(images, slot) is not None,
                  f"courtyard mesh {i}: its {slot} texture "
                  f"({getattr(mesh.texture_paths, slot)!r}) loads")
    check(bool((app.scene["mat_tex"] >= 0).all()),
          "every courtyard object samples a pool texture")
    return 3 * len(meshes)


def courtyard_kernels(ctx, rec, app) -> dict:
    """Kernels A-L against their plain versions on the courtyard frame's
    own intermediates (frames 0 and 1 of the App's run, recorded on their
    way into the kernels): A-I by check_a_to_i, J, K and L by
    check_and_time_jkl. Their times are kept as the kernels' "courtyard"
    variant."""
    ctx.tag, ctx.path = "courtyard", "runtime (courtyard, App.run_frame)"
    try:
        check_a_to_i(ctx, rec, app.scene, app.settings, atlas_time=False)
        found = check_and_time_jkl(ctx, rec, app.settings, " (courtyard)")
        del found["mv"], found["main"]
        print(f"courtyard: kernels A-L equal their plain versions on the "
              f"frame's inputs ({found['main_alpha_pairs']} alpha pairs in "
              f"the main view, {found['atlas_alpha_pairs']} alpha caster "
              "pairs in the atlas)", flush=True)
        return found
    finally:
        ctx.tag = None


def timed_runtime_frames(app, n: int) -> dict:
    """n timed App.run_frame calls with main()'s orbit input, each step
    timed on its own: run_frame (CUDA events around it and the host wall
    clock; it ends in the escalation check's fetch of debug_counters), the
    image's copy to the host, burn_stats and save_image of the 1080p PNG;
    and the host syncs run_frame makes (torch.cuda's sync debug mode)."""
    from plainrenderer_tpu_torch.assets.image_io import save_image
    from plainrenderer_tpu_torch.runtime.overlay import burn_stats

    steps = collections.defaultdict(list)
    syncs, image = [], None
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    png = OUT / "runtime_frame.png"
    for _ in range(n):
        inputs = orbit_input(app)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            start.record()
            image = app.run_frame(inputs)
            end.record()
            t1 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("default")
        end.synchronize()
        syncs.append(sum("called a synchronizing CUDA operation"
                         in str(w.message) for w in caught))
        steps["run_frame_events_ms"].append(start.elapsed_time(end))
        steps["run_frame_host_ms"].append((t1 - t0) * 1e3)
        t0 = time.perf_counter()
        host = image.cpu().numpy()
        t1 = time.perf_counter()
        stats = [f"{1e3 / steps['run_frame_host_ms'][-1]:6.1f} FPS  "
                 f"{steps['run_frame_host_ms'][-1]:7.2f} MS",
                 f"{app.settings.width}X{app.settings.height}  GI:ON"]
        framed = burn_stats(host, stats, scale=2)
        t2 = time.perf_counter()
        save_image(png, framed)
        t3 = time.perf_counter()
        steps["copy_to_host_ms"].append((t1 - t0) * 1e3)
        steps["burn_stats_ms"].append((t2 - t1) * 1e3)
        steps["save_png_ms"].append((t3 - t2) * 1e3)
    summary = {k: dict(mean=float(np.mean(v)), min=float(np.min(v)),
                       max=float(np.max(v))) for k, v in steps.items()}
    return dict(steps=summary, host_syncs_per_run_frame=syncs, image=image,
                png_bytes=png.stat().st_size)


def runtime_cli() -> dict:
    """The app's command line as a user runs it, in a subprocess: 8
    frames at WIDTH x HEIGHT of the courtyard into RUNTIME_OUT, read back with
    the port's PNG reader; then one more frame in a second subprocess that
    lists the modules it imported (no jax, nothing of the JAX
    package)."""
    import shutil

    from plainrenderer_tpu_torch.assets.image_io import load_image

    out = ROOT / RUNTIME_OUT
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "plainrenderer_tpu_torch.runtime.app",
           str(WIDTH), str(HEIGHT), COURTYARD, "--frames", "8", "--out",
           RUNTIME_OUT]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    cli_s = time.perf_counter() - t0
    print(f"runtime command line ({' '.join(cmd[1:])}): exit "
          f"{proc.returncode} in {cli_s:.1f} s; stderr tail: "
          f"{proc.stderr.strip().splitlines()[-3:]}", flush=True)
    check(proc.returncode == 0, "the runtime command line exits 0")
    pngs = sorted(out.glob("frame_*.png"))
    check([p.name for p in pngs] == [f"frame_{i:04d}.png" for i in range(8)],
          f"the command line wrote 8 PNGs: {[p.name for p in pngs]}")
    for p in pngs:
        img = load_image(p)
        check(img.shape == (HEIGHT, WIDTH, 4) and img.dtype == np.uint8
              and img[..., :3].std() > 5.0, f"{p.name} reads back")
    png_bytes = [p.stat().st_size for p in pngs]
    code = (
        "import json, runpy, sys\n"
        "sys.argv = ['app', %r, %r, %r, '--frames', '1', '--out', %r]\n"
        "runpy.run_module('plainrenderer_tpu_torch.runtime.app',"
        " run_name='__main__')\n"
        "print(json.dumps(sorted(sys.modules)))\n"
        % (str(WIDTH), str(HEIGHT), COURTYARD, RUNTIME_OUT + "/imports"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the import probe runs: {proc.stderr[-500:]}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if any(m == f or m.startswith(f + ".")
                                    for f in FORBIDDEN)]
    print(f"runtime command line imports: {len(loaded)} modules, of JAX or "
          f"the JAX package: {bad}", flush=True)
    check(not bad, f"the app imports no jax: {bad}")
    shutil.rmtree(out / "imports", ignore_errors=True)
    return dict(command=" ".join(cmd[1:]), seconds=cli_s,
                png_bytes=png_bytes, forbidden_imports=bad)


def runtime_phase(ctx) -> dict:
    """The runtime on the committed courtyard demo (assets/demo): the
    port's App at 1920x1080 with main()'s settings (3 DDS volumes read,
    none baked, the ivy's alpha masks, every texture in the pool); kernels
    A-L held to their plain versions on its frames 0 and 1; 3 warm-up
    and RUNTIME_TIMED timed run_frames with the launch counts reset just
    before the timed ones and read just after, each step timed; the debug
    views at 1080p; a small App frame and each debug view card vs CPU at
    256x128; the command line in subprocesses."""
    t0 = time.perf_counter()
    app = runtime_app(ctx.dev, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check((app.sdf_loaded, app.sdf_baked) == (3, 0),
          f"the courtyard's 3 DDS volumes read, none baked: "
          f"{app.sdf_loaded}, {app.sdf_baked}")
    check("alpha_masks" in app.scene, "the ivy's alpha masks are built")
    n_tex = courtyard_textures_reach_the_pool(app)
    print(f"runtime: App on {COURTYARD} at {WIDTH}x{HEIGHT} in {load_s:.2f} "
          f"s (3 DDS volumes, {n_tex} textures, alpha masks); settings: "
          f"GI {app.settings.sdf_trace.enabled}, pair_budget_scale "
          f"{app.settings.pair_budget_scale}", flush=True)
    with recorded_calls(A_TO_I_CALLS) as rec:
        for _ in range(2):
            app.run_frame(orbit_input(app))
    found = dict(load_s=load_s, kernels=courtyard_kernels(ctx, rec, app))
    del rec
    for _ in range(RUNTIME_WARMUP - 2):
        app.run_frame(orbit_input(app))
    torch.cuda.synchronize()
    native.reset_launch_counts()
    run = timed_runtime_frames(app, RUNTIME_TIMED)
    torch.cuda.synchronize()
    launches = native.launch_counts()
    n = RUNTIME_TIMED
    print(f"runtime: launches over {n} timed run_frames: {launches}; host "
          f"syncs per run_frame {run['host_syncs_per_run_frame']}",
          flush=True)
    for name, k in _BENCH.items():
        check(launches[name] >= k * n,
              f"runtime: kernel {name} launched {k}x per frame")
    for name in set(KERNEL_SOURCES) - set(_BENCH):
        check(launches[name] == 0, f"runtime runs no {name} kernel")
    check(all(s == 1 for s in run["host_syncs_per_run_frame"]),
          "run_frame syncs once: the escalation check's debug_counters")
    counters = app.state.debug_counters.cpu().numpy()
    image = run.pop("image")
    mean, std = float(image.float().mean()), float(image.float().std())
    print(f"runtime: final pair_budget_scale "
          f"{app.settings.pair_budget_scale:g}, debug_counters "
          f"{counters.tolist()}; image {tuple(image.shape)} mean {mean:.2f} "
          f"std {std:.2f}", flush=True)
    check((counters == 0).all(), "runtime: debug_counters [0, 0]")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3) and 2 < mean < 253
          and std > 5, "runtime: a plausible image")
    steps = run["steps"]
    print("runtime steps (ms per frame, mean/min/max over "
          f"{n}): " + json.dumps(steps), flush=True)
    found.update(run, launches=launches, frames=n,
                 pair_budget_scale=app.settings.pair_budget_scale,
                 image_mean=mean, image_std=std,
                 **profile_frames(ctx, None, None, None, "runtime",
                                  lambda: app.run_frame(orbit_input(app))))

    # the debug views at 1080p: each changes the frame
    base = fresh_frame(app, app.settings)
    views = {}
    for name, settings in debug_view_settings(app.settings).items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = fresh_frame(app, settings)
        ms = (time.perf_counter() - t0) * 1e3
        share = float((img != base).any(axis=-1).mean())
        views[name] = dict(frame_host_ms=ms, pixels_changed=share)
        check(share > 0.0, f"the {name} view changes the 1080p frame")
    print("runtime debug views at 1080p (one frame from a fresh state, "
          "host ms with the copy; share of pixels changed): "
          + json.dumps(views), flush=True)
    found["debug_views_1080p"] = views
    del app, base
    torch.cuda.empty_cache()

    # card vs CPU at 256x128: two App frames, then each debug view
    small = [runtime_app(d, 256, 128, demo=True) for d in (ctx.dev, "cpu")]
    for i in range(2):
        card, cpu = (a.run_frame().cpu().numpy() for a in small)
    close = golden_close(card, cpu)
    check(close > 0.999, f"small courtyard App card vs CPU: {close:.5f}")
    small_views = {}
    plain = [fresh_frame(a, a.settings) for a in small]
    for name, settings in debug_view_settings(small[0].settings).items():
        card, cpu = (fresh_frame(a, settings) for a in small)
        small_views[name] = golden_close(card, cpu)
        check(small_views[name] > 0.999 and (card != plain[0]).any(),
              f"{name} at 256x128: card vs CPU {small_views[name]:.5f}, "
              "and it changes the image")
    print(f"runtime at 256x128 (tests/test_demo_asset.py's settings): App "
          f"frames card vs CPU {close:.5f}; debug views card vs CPU "
          + json.dumps(small_views) + " (limit > 0.999)", flush=True)
    found.update(small_card_vs_cpu=close, small_debug_views=small_views)
    del small
    found["command_line"] = runtime_cli()
    return found


# --------------------- modules off the frame's path ---------------------

BRDF_LUT = (512, 1024)  # the default bake: texels per side, samples
BRDF_SMALL = (64, 256)  # card vs the CPU's plain bake
BRDF_FIT = (128, 1024)  # the grid the fitted polynomials were fitted on
BRDF_CPU_TOL = 1e-5
# env_brdf_fit.py's recorded |fit - bake| (mean, max) per channel, to 4
# decimals: the check allows half the last digit plus 2e-4 for the card's
# bake against the one the fit was made from
BRDF_FIT_BOUNDS = {"bias": (0.0019, 0.0880), "k": (0.0026, 0.0144),
                   "z0": (0.0, 0.0), "z1": (0.0004, 0.0052),
                   "z2": (0.0009, 0.0154), "z3": (0.0004, 0.0040)}
BRDF_FIT_SLACK = 0.00005 + 2e-4
JPEG_FIXTURES = ROOT / "tests" / "data" / "jpeg"


def brdf_fit_errors(lut, diffuse_brdf: int) -> dict:
    """|fit - bake| (mean, max) of a BRDF_FIT bake against the fitted
    polynomials in f64, on the grid and coordinates the fit used
    (tools/fit_env_brdf.py)."""
    n = lut.shape[-1]
    ax = torch.arange(n, dtype=torch.float64)
    r = torch.clamp_min(ax / n, 1e-4)[None, :].expand(n, n)
    nov = (torch.clamp_min(ax, 0.1) / n)[:, None].expand(n, n)
    s = nov / (r + nov + 1e-6)
    lut = lut.double().cpu()

    def err(coef, u, v, ch):
        e = (brdf_lut._poly6(np.asarray(coef, np.float64), u, v)
             - lut[ch]).abs()
        return float(e.mean()), float(e.max())
    out = {f"z{diffuse_brdf}": err(brdf_lut._Z_COEFS[diffuse_brdf], r, nov,
                                   2)}
    if diffuse_brdf == 0:
        out["bias"] = err(env_brdf_fit.BIAS_SV, s, nov, 0)
        out["k"] = err(env_brdf_fit.K_RS, r, s, 1)
    return out


def brdf_bake(ctx) -> dict:
    """bake_brdf_lut on the card for each diffuse_brdf: the default 512^2
    x 1024 bake timed (CUDA events; peak memory above what was allocated
    before), finite and in range; the card's 64^2 x 256 bake against the
    plain bake on the CPU within BRDF_CPU_TOL; the card's 128^2 x 1024
    bake against the fitted polynomials within env_brdf_fit.py's recorded
    bounds (BRDF_FIT_BOUNDS, BRDF_FIT_SLACK)."""
    found = {}
    for mode in range(4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        lut = brdf_lut.bake_brdf_lut(*BRDF_LUT, mode, device=ctx.dev)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        peak_mb = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
        check(tuple(lut.shape) == (3,) + BRDF_LUT[:1] * 2
              and bool(torch.isfinite(lut).all())
              and float(lut.min()) >= 0.0 and float(lut[:2].max()) <= 1.1,
              f"BRDF bake {mode}: (3, 512, 512), finite, in range")
        card = brdf_lut.bake_brdf_lut(*BRDF_SMALL, mode, device=ctx.dev)
        cpu = brdf_lut.bake_brdf_lut(*BRDF_SMALL, mode, device="cpu")
        err = float((card.cpu() - cpu).abs().max())
        check(err <= BRDF_CPU_TOL, f"BRDF bake {mode} at 64^2 x 256: card vs "
              f"CPU max |err| {err:.3e} (limit {BRDF_CPU_TOL})")
        fit = brdf_fit_errors(
            brdf_lut.bake_brdf_lut(*BRDF_FIT, mode, device=ctx.dev), mode)
        for name, (mean, mx) in fit.items():
            lim_mean, lim_max = BRDF_FIT_BOUNDS[name]
            check(mean <= lim_mean + BRDF_FIT_SLACK
                  and mx <= lim_max + BRDF_FIT_SLACK,
                  f"BRDF bake {mode}: |fit - bake| of {name} mean {mean:.5f} "
                  f"max {mx:.5f} within env_brdf_fit.py's {lim_mean:.4f} / "
                  f"{lim_max:.4f} + {BRDF_FIT_SLACK}")
        print(f"BRDF bake (diffuse_brdf {mode}): {BRDF_LUT[0]}^2 x "
              f"{BRDF_LUT[1]} in {ms:.2f} "
              f"ms (CUDA events), peak {peak_mb:.1f} MiB above the "
              f"baseline; 64^2 x 256 card vs CPU max |err| {err:.3e} "
              f"(limit {BRDF_CPU_TOL}); 128^2 x 1024 against the fitted "
              "polynomials (mean, max): " + json.dumps(fit) + " (limits "
              f"env_brdf_fit.py's + {BRDF_FIT_SLACK})", flush=True)
        found[str(mode)] = dict(ms=ms, peak_mib=peak_mb, card_vs_cpu=err,
                                fit=fit)
        del lut
    return found


def jpeg_fixtures() -> dict:
    """The committed JPEG fixtures through load_image (this machine has
    no PIL): each equal to PIL's decode committed beside it as PNG, and
    the decode's host wall time (the best of 3 loads)."""
    found = {}
    names = sorted(p.stem for p in JPEG_FIXTURES.glob("*.jpg"))
    check(names == ["baseline420", "grey", "progressive", "restart"],
          f"the JPEG fixtures: {names}")
    for name in names:
        want = image_io.load_image(JPEG_FIXTURES / f"{name}.png")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = image_io.load_image(JPEG_FIXTURES / f"{name}.jpg")
            times.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(got, want), f"JPEG {name} equals PIL's decode")
        found[name] = dict(shape=list(got.shape), load_ms=min(times))
    print("JPEG fixtures decoded equal to PIL's PNGs (host ms, best of 3): "
          + json.dumps(found), flush=True)
    return found


def modules_phase(ctx) -> dict:
    """The modules off the frame's path: the Monte Carlo BRDF bake
    (brdf_bake) and JPEG decoding (jpeg_fixtures)."""
    return dict(brdf_bake=brdf_bake(ctx), jpeg=jpeg_fixtures())


# ----------------------- image formats (PR 16) -----------------------

FORMAT_FIXTURES = ROOT / "tests" / "data" / "formats"
# tests/test_torch_formats.py _fixture_files: each beside PIL's decode
FORMAT_NAMES = (
    "anim.webp", "bigtiff_rgb.tif", "bilevel_whiteiszero.tif", "cmap16.tga",
    "cmyk.jpg", "cmyk_lzw.tif", "cmyk_raw.psd", "cut_ac.jpg", "cut_dc.jpg",
    "float_pred3.tif", "grey.dcx", "grey.gif", "grey16_mm.tif", "grey8.bmp",
    "grey8_topleft.tga", "interlaced_transparent.gif", "local_offset.gif",
    "lossless.webp", "lossy.webp", "lossy_alpha.webp", "orient6.tif",
    "p1.pbm", "p2_maxval15.pgm", "p3.ppm", "p4.pbm", "p5_16bit.pgm",
    "p6_maxval1000.ppm", "pal4.bmp", "pal4_packbits.tif", "pal4_planes.pcx",
    "pal8.pcx", "pal8_mask.ico", "palette.gif", "rgb.pcx", "rgb.sgi",
    "rgb16.tga", "rgb24.bmp", "rgb24.dib", "rgb24.tga", "rgb565.bmp",
    "rgb_jpeg.tif", "rgb_lzw_pred.tif", "rgba.ico", "rgba.qoi", "rgba16.sgi",
    "rgba32.cur", "rgba32_rle.tga", "rgba32_v5.bmp", "rgba_assoc_planar.tif",
    "rgba_deflate_tiled.tif", "rgba_packbits.psd", "rgba_rle.sgi", "rle4.bmp",
    "rle8.bmp", "ycbcr21_deflate.tif", "ycbcr_jpeg.tif", "ycbcr_lzw.tif",
    "ycck.jpg")
# tests/test_torch_formats_legacy.py fixture_files: PIL's legacy formats
# (PR 18), each beside PIL's decode
LEGACY_FORMAT_FIXTURES = ROOT / "tests" / "data" / "formats_legacy"
LEGACY_FORMAT_NAMES = (
    "a.xbm", "band.iim", "bc3_dx10.tex", "bc4.tex", "bc5s.tex",
    "bgr24_rle.ras", "bits.ras", "blp1_jpeg.blp", "blp1_pal.blp",
    "blp2_dxt1_alpha.blp", "blp2_dxt5.blp", "blp2_pal.blp", "brun.fli",
    "cmyk.pnm", "dxt1.ftc", "dxt1.tex", "dxt3.tex", "f32.fits", "float.pfm",
    "float.spi", "grey.imt", "grey_v1.gbr", "gzip_tiles.fits", "i16.area",
    "i16.fits", "lab.psd", "lab.tif", "lc_ss2.flc", "lstar12.im", "lut.im",
    "pal.xpm", "pal8.ras", "pal8.tex", "png.icns", "raw.iim", "rgb.ftu",
    "rgb.pxr", "rgb300.xpm", "rgb565_masks.tex", "rgba.im", "rgba1000.pnm",
    "rgba_v2.gbr", "rle_mask.icns", "thumb.xv", "v1.msp", "v2_rle.msp",
    "ycc.im")
# tests/test_torch_formats_codecs.py fixture_files: the TIFF codecs and
# JPEG modes (CCITT, LZMA, ZSTD, old-style LZW and JPEG, 12-bit, planar;
# arithmetic and lossless JPEG), each beside PIL's decode
CODECS_FORMAT_FIXTURES = ROOT / "tests" / "data" / "formats_codecs"
CODECS_FORMAT_NAMES = (
    "arith_420_restart.jpg", "arith_progressive.jpg",
    "ccitt_g3_1d_eolfill.tif", "ccitt_g3_2d_whiteiszero.tif", "ccitt_g4.tif",
    "ccitt_mh_fill2.tif", "grey12_deflate.tif", "jpeg12.tif",
    "jpeg_planar_tables.tif", "lossless_rgb_pred6_pt1.jpg", "lzma_pred.tif",
    "lzw_old_pred.tif", "ojpeg_jif.tif", "ojpeg_tables_strips.tif",
    "planar_ycbcr_deflate.tif", "planar_ycbcr_raw.tif", "zstd_rgba.tif")
# tests/test_torch_formats_j2k.py fixture_files: JPEG 2000, each
# beside PIL's decode; its courtyard/ folder holds the 12 textures as JP2
J2K_FORMAT_FIXTURES = ROOT / "tests" / "data" / "formats_j2k"
J2K_FORMAT_NAMES = (
    "bypass_termall_segsym.jp2", "cut_in_part.j2k", "grey16.jp2",
    "jp2_elements.icns", "pclr.jp2", "ppt_sop_eph.j2k", "rgn_vsc_reset.j2k",
    "rpcl_precincts_poc.j2k", "sycc_subsampled.jp2", "tiles_97.j2k")
COURTYARD_JP2 = J2K_FORMAT_FIXTURES / "courtyard"
# SHA-256 of PIL's RGBA decode of each courtyard JP2 (PIL's irreversible
# save at 40:1; tests/test_torch_formats_j2k.py checks them against PIL)
COURTYARD_JP2_SHA256 = {
    "ivy_albedo": "f2a14f6daeeceeba8aa4ed1bfbeb2fe6"
                  "1471875d574e3dfade1d1661cebc72a5",
    "ivy_mr": "fdf3f4ae6e735cfdc35ff8634df1db95"
              "15a6603f0a064ab8539c90adc1c73635",
    "ivy_normal": "809e6e76a4b5b930ae0cea544f19ea44"
                  "ba0dcf4de895db14041f47f141ca8817",
    "metal_albedo": "f0d6c0dffa07d596642a8bc2aca14c20"
                    "68c579a1bcb6a8e4a540294f45655c96",
    "metal_mr": "f96d60f457df8389b42874b895b997b7"
                "11287bda9e82ac97178d8560a8e71d2a",
    "metal_normal": "46ce91d915173a63c4e38588ccbaf70e"
                    "a61fd09d5da2848ca695cb5c4c43b1ba",
    "stone_albedo": "69976ce8e67b8ea33b1c3b40cdf9fd7c"
                    "636eac0d587d71d072c8c81f04d8c153",
    "stone_mr": "0190ff4d575d222f92fc6f82433b7cf6"
                "7a2bd898243ef91e30be8130bad55add",
    "stone_normal": "b34c2e9f9b5b0a9c054ad52609b9f1e5"
                    "58c702d40008dfcd1382a937d1cf8d48",
    "wood_albedo": "e52669d35c203b3b677334772dcb9d3f"
                   "ef5289e69a94697d38eb71bdffef9d7d",
    "wood_mr": "f19868b1c4d987700321582da6227829"
               "023ec54ceb8f836ca30e035f16c505e1",
    "wood_normal": "4461b119d95468f07dd3d741a4fedf4e"
                   "fc7022e67b363dc53f9829f653dc126d"}
# tests/test_torch_formats_avif.py fixture_files: AVIF, each beside PIL's
# decode; its courtyard/ folder holds the 12 textures as PIL's default
# AVIF saves (libaom 3.12.1 at quality 75, speed 6, 4:2:0)
AVIF_FORMAT_FIXTURES = ROOT / "tests" / "data" / "formats_avif"
AVIF_FORMAT_NAMES = (
    "cdef_lr_speed0.avif", "default_rgb.avif", "grain.avif", "grid.avif",
    "idat.avif", "limited_422.avif", "lossless_444.avif", "mono_400.avif",
    "qm.avif", "rgba_premultiplied.avif", "screen_intrabc.avif",
    "screen_palette.avif", "sequence_rgba.avif", "tiles.avif")
COURTYARD_AVIF = AVIF_FORMAT_FIXTURES / "courtyard"
# SHA-256 of PIL's RGBA decode of each courtyard AVIF (libavif 1.3.0 with
# dav1d 1.5.1; tests/test_torch_formats_avif.py checks them against PIL)
COURTYARD_AVIF_SHA256 = {
    "ivy_albedo": "0d03c814b2799c3c42fb6431f8fe061b"
        "1577ae199c17066dc507de7907a3c362",
    "ivy_mr": "44e0b70d394781e2c52df176547c8f7d"
        "90bb96005f675efd505252fb6a7283bb",
    "ivy_normal": "cfc4d4df969adbb9ff8ae4d911f94d18"
        "95112ea77641af24286fa9c040aa9a50",
    "metal_albedo": "edafec0e9b38e87beaa4218a10a00e84"
        "b36756159925405f6d8fdad62ded5b98",
    "metal_mr": "7e4ea38bc6cab9a5bb22c3bcfc2c8ae0"
        "93323cdcd3f5ead4b78f05a57dc9a303",
    "metal_normal": "f2354cc492e2682f01709fefc0b585be"
        "8d1cfad16913ebde632ec768e3c58ed3",
    "stone_albedo": "b0bd13739a2ddc7ee0873310aabac26c"
        "1d684c62f63e1aab99bd08e3dcd74185",
    "stone_mr": "6f02f181c2dca4825131a4691df4a22a"
        "d0187891f02575e11b24738e6044f323",
    "stone_normal": "cfa5b359a4aa5011055485af8cb8b735"
        "9dd7bc04d9c8f4c28619c809a2a8114e",
    "wood_albedo": "2fbbbc1d98a50b53dfc54cdc740ae145"
        "8a291a64d6eb8135d2adf9d2f508720b",
    "wood_mr": "7d6c9bc4ba64f237821489657b76cf74"
        "ac5fa16e76dd12387cfba9dce63520f2",
    "wood_normal": "895ed03705e5265cbf97b80f4831a28d"
        "c08f9a7172e2b5a9851ccb8b70dd4af0"}
# tests/test_torch_formats_avif_matrix.py fixture_files: AVIF in the
# matrices libavif converts without libyuv (identity, YCgCo, FCC, SMPTE
# 240, chromaticity-derived, 15) and items whose ispe is not their
# frame's size, each beside PIL's decode as PNG; courtyard_ycgco/ the 12
# courtyard textures as YCgCo 4:2:0 files libavif writes at its default
# quality
AVIF_MATRIX_FIXTURES = ROOT / "tests" / "data" / "formats_avif_matrix"
AVIF_MATRIX_NAMES = (
    "derived_p22_420.avif", "derived_p9_420_prem.avif",
    "fcc_420_limited.avif", "identity_400.avif",
    "identity_lossless_texture.avif", "ispe_20x16.avif", "ispe_30x20.avif",
    "matrix15_444.avif", "smpte240_422_rgba.avif", "ycgco_420_rgba.avif",
    "ycgco_422.avif")
COURTYARD_AVIF_YCGCO = AVIF_MATRIX_FIXTURES / "courtyard_ycgco"
# SHA-256 of PIL's RGBA decode of each (libavif 1.3.0 with dav1d 1.5.1;
# tests/test_torch_formats_avif_matrix.py checks them against PIL)
COURTYARD_AVIF_YCGCO_SHA256 = {
    "ivy_albedo": "e01b82c364f4cd6f18e13673184c04ef"
                  "208473b97463d720afed29506c9872fa",
    "ivy_mr": "fdf3f4ae6e735cfdc35ff8634df1db95"
              "15a6603f0a064ab8539c90adc1c73635",
    "ivy_normal": "21e7951a54b8954b36ede026142f1b18"
                  "2f0dc95e57fccc4a1bef8013d293e7d6",
    "metal_albedo": "58c2f5010f3ae44b40ccca907a23301d"
                    "15f86cb3d83ae9efe550728189e6060b",
    "metal_mr": "cad32706862e9ff4f846d669f05dc35e"
                "4e98594a208f9ae907f781e69283f1fa",
    "metal_normal": "12dd602efa0b743454729b754537779e"
                    "22f781dc64aff231cab1f90f56ea3fd3",
    "stone_albedo": "3aa41db7c4c70484583317580ad59f26"
                    "068729f2f7770df80e046dad0f15df3f",
    "stone_mr": "05277d7b09a1cbceaf325cde4b16cc61"
                "f3114b6e446505af8932f5786fba7c7c",
    "stone_normal": "19367170fbf40a367631368537940268"
                    "2f5cd57bdd8ca97f80f3971ffcb0e191",
    "wood_albedo": "04d50a7dd7c191dc8e44a86cbfe8e0d3"
                   "77b7f0fa074cfddccc4ba2fe9a9c0ebb",
    "wood_mr": "f19868b1c4d987700321582da6227829"
               "023ec54ceb8f836ca30e035f16c505e1",
    "wood_normal": "83c2d3113396c340902fac87dd5a83eb"
                   "cf07226dad0748da9360aa4d1d1a958d"}
# tests/test_torch_formats_avif_hbd.py fixture_files: the AVIF fixtures
# above rewritten to 10 and to 12 bits (tests/torch_avif_depth.py: the
# sequence header, av1C and pixi), and one courtyard texture at 10 bits;
# SHA-256 of PIL's RGBA decode of each (libavif 1.3.0 with dav1d 1.5.1),
# None where PIL refuses the file
AVIF_HBD_FIXTURES = ROOT / "tests" / "data" / "formats_avif_hbd"
AVIF_HBD_SHA256 = {
    "cdef_lr_speed0_10": "68c0ce48ef74614500512824d826b2e1"
        "a332d3e1c6200803a237068c48769d6d",
    "cdef_lr_speed0_12": "dedff2e53b764dac5460d40fe5ea1f5d"
        "6736ab55db9b17a888f43d4fef8d2cfe",
    "courtyard_wood_albedo_10": "a1f14d7d14e0167f2b3619a1a34aa922"
        "23b8333f6c0f55ef1f3319108652fd13",
    "default_rgb_10": "875f2f5e57831bc45fb60a3935eb9e85"
        "7e30bf7ee1294ad3684112c4190ae21d",
    "default_rgb_12": "390792a90a008406320b2eb2146c4886"
        "0ec21aad2124f6cdac8ccc65ce0986a4",
    "derived_p22_420_10": "f057eead64433efcb9e40eea710df23b"
        "7a9761cd4a2288ba222f37a1a1e2126d",
    "derived_p22_420_12": "12dc1b0681403737572f1d04248d8c62"
        "676049671f00128c6929ac41ac206468",
    "derived_p9_420_prem_10": "830e19740c1aad5025580e0fcdaa04c1"
        "a99b8c71372bba2dc5257113123da287",
    "derived_p9_420_prem_12": "17bad7354a9040ac9a029100a4317f13"
        "1fd02e66bee0bf544f0939de25bd843d",
    "fcc_420_limited_10": "5055b05899ef43015812b1b0637790dc"
        "c910670c6cc28e18af48bbbd83955770",
    "fcc_420_limited_12": "188dbb66014ef365b0f610f0baa62ceb"
        "f0753c8d88194d130441f09f3f84082a",
    "grain_10": "cfa756977cf693caa5e4ac3744165cc5"
        "e2340d253e0f09b104a1c0c247eff381",
    "grain_12": "a6f8e8730630512f990ece8d120fe25f"
        "764abe8b478446026d35c32151611467",
    "grid_10": "bd328c8e556fd24079c5cb06a6910006"
        "54888e24f6b887cb4a3299d3a3a60baa",
    "grid_12": "a7116c68f64624fa47eb40db871a42cb"
        "d12787ccdce0c852f13470cf1bfc925f",
    "idat_10": "0fd5105e804197bf1b9e374834bea7ca"
        "6d5f1e4d9d95af022ab5ea1ed4ebd910",
    "idat_12": "8f571fd49b5cab733cfb3ae6a7ce2c6c"
        "1189d9ba942b2aed904aa6d1381700ed",
    "identity_400_10": "d627de7fe07ba265ba5fec2c41537c88"
        "325a7ebe10c1b2c83578677df3acbf83",
    "identity_400_12": "fcc7abbc3c303780d00d71fc7d2965d4"
        "066420b9d3f813fd04b1acd12a1e44eb",
    "identity_lossless_texture_10": None,
    "identity_lossless_texture_12": "59405bb6c3f8bc16105660072b266639"
        "583c4c9ca0392188154af7abf53c16cd",
    "ispe_20x16_10": "34dbb46fc4b38744e6b80d12b66a9380"
        "5ab2171a1f4364d013c80658ceaa2d77",
    "ispe_20x16_12": "afc832a5fdcea9121b50c6d3cfb479b4"
        "2c9815f314f8b67a445cbc275c0e3caa",
    "ispe_30x20_10": "ae23c8ec3c3c7cf4348d11ab03f0eede"
        "47ae9ca070549069f9f68cd8830f3ab2",
    "ispe_30x20_12": "fb6cda18632c3c2b7191e05ea88ff9c0"
        "1f1e4be70eb4a53616d0d9d9068f30d5",
    "limited_422_10": "e0d76dbf3e1769758784ed47eeaf11ed"
        "fedffad941981558673c89bcde012ced",
    "limited_422_12": "6fc1ae77176a71863ff293fb376a3dde"
        "b2162ea977810cfa206fd4ae4a5f5e07",
    "lossless_444_10": "59eea4679c2466d73bd86cdf3c3ffc2f"
        "f3f6ffd0eb65bec8374298d33677a9bb",
    "lossless_444_12": "caa8fb0ad1900a7b39f7f6e842b7079b"
        "3f8de8d00a6e434eaf086a27664b61c7",
    "matrix15_444_10": "5153f5573d6258ffcdfa13a485696e53"
        "d892de585e970be5298846b1bdeb2f20",
    "matrix15_444_12": "ad06c917d5304be0a6721fdc1fb7908f"
        "c98258d5acefcbe4bf2722a25c2425df",
    "mono_400_10": "f34bafef7d8a9a8475bacd5d0a72f2eb"
        "a664e4972b5d530520a6bfb516cc10ef",
    "mono_400_12": "782ff016a4374a96ca68486914ad965f"
        "5d8631b7cfb9d31e5e59194fae44c807",
    "qm_10": "4a8cee14ecf158a93385b5e613749579"
        "ae4c9d6b45c3b59170c340fbb27d6c63",
    "qm_12": "4fbf6c667d9b02a8d41347e38f8e826e"
        "6731dfa5c5c451a91b6158feb37e0cf3",
    "rgba_premultiplied_10": "69c1df98134d00b8070463ded945875c"
        "a761be9b4f41ac831ba2e0a323a730d5",
    "rgba_premultiplied_12": "511b79b160d7f8c7e4d3e1a5a724df30"
        "a735623f5a81c7d8c7bb66a3ce0c6f42",
    "screen_intrabc_10": "3a03f0ce611409d9bbbac74e935488db"
        "91eccca70e13a94fb56e04f566f728a5",
    "screen_intrabc_12": "8d0a53c524a03c64830d735c61bd35c9"
        "9d1dfd28a674f449dd17d992f0c34d2a",
    "screen_palette_10": None,
    "screen_palette_12": None,
    "sequence_rgba_10": "87a61bb42cca3c1e14d855822584ba67"
        "18a674d3aedf5ccca54eceedade96e55",
    "sequence_rgba_12": "0bae45dfca76f038a6f72aad562d49d7"
        "1d55936ef41bc9a26719231ceff447f6",
    "smpte240_422_rgba_10": "4791e221402c28fd1fc355999c79e36d"
        "0ad3a9ac70dc26f559747cd1700ee313",
    "smpte240_422_rgba_12": "8c62896259ddf9f81dc18f88594a6525"
        "316d8be13defed0e279fcad915721084",
    "tiles_10": "57da11b8f7fb01761bcf892388e89fe8"
        "4d713032443d074a8171748efafd00e8",
    "tiles_12": "56ada08cbd9b2ee699608a9b13d121a4"
        "80f3a7bfa593c62f1a4f740594c02b67",
    "ycgco_420_rgba_10": "fb7ddb0ee0570b1d778b016918ee2b0a"
        "834262bbc42bb0e55ff0639b4ffe43b8",
    "ycgco_420_rgba_12": "5a1acbedbae62f87e47c16657933e1d2"
        "0470b5791f5be629e2d678023a8adfa7",
    "ycgco_422_10": "c93894c981a9c9ac24b5a929878f7061"
        "c31de690343e4e254dabe1c084d607d4",
    "ycgco_422_12": "842c60f46d279797e86b69b464d1c80b"
        "f250d1a6a1777163230ff5ae76e5bad1",
}
# tests/torch_avif_superres.py fixture_files: superres AVIF (AV1 key
# frames coded at the reduced width, denominators 9-16, which PIL's save
# cannot write), courtyard_d16 the wood albedo's 200 x 128 coded at 100
# columns by the port's intra search; SHA-256 of PIL's RGBA decode of
# each (libavif 1.3.0 with dav1d 1.5.1)
AVIF_SUPERRES_FIXTURES = ROOT / "tests" / "data" / "formats_avif_superres"
AVIF_SUPERRES_SHA256 = {
    "courtyard_d16": "69350ec65cf76ce27c031ccde01012f7"
        "9720937ceb8d6ac95fbd39320ec00d06",
    "courtyard_d16_10": "b7906d2dfe8f0f3bc356a2f2c18ecdd9"
        "e20151cb0cc3861c40038953309b1215",
    "d10_420_sb128_lr256": "b0a65246703ae416fdb9c0eb3bd7f5bf"
        "d595259d89879b4c280192f0f0eb61a4",
    "d10_444_lr64": "891dab8eb60c5817a3b5d8664e8cfa06"
        "10530501f81b5174b97059cce48f1bdd",
    "d10_444_lr64_10": "4cd22a5e63ec78ad01baddd7270ca0a6"
        "295c770f0c15e520794297bc18083dfa",
    "d11_400_odd": "c1d84f9c2b198699859faf3714395733"
        "971fabc206f3fdda090bdc461d5f1474",
    "d11_400_odd_12": "258080c0467db1ac45fa4b2fcf42a1b4"
        "7032a64d115e704116d3a94e164276b5",
    "d12_420_alpha": "137c023a81f485b4fcd05136112e9820"
        "5252e4c4c7379b0c32241f42f7299230",
    "d12_420_alpha_10": "57344c6d11f323a54af228ce4dd85ab1"
        "94dee77614fc54e48233a59e3d386954",
    "d12_420_lossless": "8f71e8729578ea3fa54a087078112884"
        "9e0c284bcab118ea41d33b76621a70fb",
    "d13_422_lr128": "c3320035b554057fbe779b6f7edb2b35"
        "01c430a89fee4af7b25f3e10cc85a286",
    "d13_422_lr128_12": "392d865200e5e22128fb5d06548aa089"
        "332229edfcfdf565d2375b0e3e4f73ca",
    "d14_420_grain": "54a022d2aeaa74c135aea4feebb865d6"
        "4ccc6d998e6e50aa8a190aed6a02c5d1",
    "d14_420_grain_10": "149243750523eddbf93dea549ac58402"
        "40d5b28286af790b06cc66822889ff2d",
    "d15_420_tiles": "0575b481d8b834611f82dfe84121f36c"
        "6c8390de0a06a83cfcc3db40284249de",
    "d16_floor_12_screen_lossless": "518354e8a9b05029ee0c1328b9277788"
        "9bddbb8c99abaa00af23dc92fd012635",
    "d16_floor_20": "30d9ae28dc1a6f9445d22755b47e2110"
        "002020e060b0b7ee9c5ff689b12256ce",
    "d9_420_sb128_tiles": "8d158c174294501e9d3f7a878d59f365"
        "cdb1d7266d91a50d988ffa9294095643",
    "d9_420_sb128_tiles_12": "d14f5649e43d314cbf03747e3936e188"
        "19101fdeb85da7b8ac0f9739f2d14d6b",
    "d9_sequence": "9cc0f460b2a661bde660cf670a9eb65d"
        "3811945e7a87836285428bc55e14b6fd",
}
# tests/test_torch_formats_htj2k.py fixture_files: HTJ2K (Part 15)
# code-blocks from the test-side writer, each beside PIL's decode
# (OpenJPEG 2.5.4) as PNG; courtyard/ the 12 courtyard textures as
# HTJ2K 9/7 codestreams
HTJ2K_FORMAT_FIXTURES = ROOT / "tests" / "data" / "formats_htj2k"
HTJ2K_FORMAT_NAMES = (
    "cblk_1024x4.j2k", "cleanup_only_warning.j2k", "elements.icns",
    "grey16.j2k", "irreversible_97_two_pass.j2k", "layers_spread.j2k",
    "lossless_53_rgb.j2k", "rgba.jp2", "rgba_97_three_pass.j2k",
    "rpcl_precincts.j2k", "stripe_causal_8x8.j2k", "three_pass_53.j2k",
    "tiles_97.j2k")
COURTYARD_HTJ2K = HTJ2K_FORMAT_FIXTURES / "courtyard"
# SHA-256 of PIL's RGBA decode of each (tests/test_torch_formats_htj2k.py
# checks them against PIL)
COURTYARD_HTJ2K_SHA256 = {
    "ivy_albedo": "39a9be7d9a4b5e55b9882c663a4cafeb"
                  "8192263494b082139727d3fad2d83702",
    "ivy_mr": "fdf3f4ae6e735cfdc35ff8634df1db95"
              "15a6603f0a064ab8539c90adc1c73635",
    "ivy_normal": "108317bba790881736b2a2ed532b401a"
                  "100d1d7d18b447581e29e60efaf4245b",
    "metal_albedo": "2a3873e6205054cd49e05985d5134b08"
                    "07879a434606b8ebe957bdd756ab704d",
    "metal_mr": "f96d60f457df8389b42874b895b997b7"
                "11287bda9e82ac97178d8560a8e71d2a",
    "metal_normal": "ef9e770a522ad521bf0f4d137e5f54f4"
                    "08ed5dfbb7c6a48d899ff29df947304e",
    "stone_albedo": "3bba1d599ef92a41601c587060cc2907"
                    "45bc6741fc71ce9aabf1f2ea3f5ce96a",
    "stone_mr": "e80b584a490d2c66f40db9bbde7a99cc"
                "2937c8a2bd643bc40c1a2ed4795dcb50",
    "stone_normal": "df053688eb570d5ea4a906d15bca7687"
                    "8f9b428105bcf7b65cb87278f0e39a5e",
    "wood_albedo": "9681a0b21bda56e9314d23a00433e816"
                   "0b98a0a25cd6dad031aa6b77c3c569fe",
    "wood_mr": "f19868b1c4d987700321582da6227829"
               "023ec54ceb8f836ca30e035f16c505e1",
    "wood_normal": "04227a3210c0e1beb71a26ec97f86b2b"
                   "573d5c9f5c3974490b277d6d0f4b96e1"}
# tests/test_torch_formats_bcn.py fixture_files: BC6H and BC7 as DDS
# content under other suffixes, each beside PIL's decode as PNG, and a
# Radiance file beside the JAX package's load_image result as .npy
BPTC_FORMAT_FIXTURES = ROOT / "tests" / "data" / "formats_bptc"
BPTC_FORMAT_NAMES = ("bc6h_sf16.bin", "bc6h_uf16.tex", "bc7.tex",
                     "bc7_srgb.dat", "radiance.hdr")
# save_image's writers of GIF, EPS / PS, PDF, MPO, ICO, ICNS and JPEG 2000
# (JP2 and a bare J2K codestream) on writer_image's arrays: (height,
# width) by suffix, the modes PIL writes (RGBA as EPS, PS or MPO is
# refused), the clock PDF dates are taken at, and PIL's save of each
# (tests/test_torch_formats_writers.py checks them against PIL): the
# file's SHA-256, and for ICO and ICNS icon_digest
WRITER_SIZES = {".gif": (96, 128), ".eps": (40, 56), ".ps": (40, 56),
                ".pdf": (64, 80), ".mpo": (64, 80), ".ico": (300, 260),
                ".icns": (48, 48), ".jp2": (96, 128), ".j2k": (96, 128),
                ".webp": (96, 128)}
WRITER_REFUSED = {".eps": ("RGBA",), ".ps": ("RGBA",), ".mpo": ("RGBA",)}
# save_image's AVIF writer on writer_image's arrays: the AV1 tile data is
# the port's own intra search (assets/av1_intra_search.py), so the bytes
# held are the port's, written on the development host (its integer
# search gives them on any host; tests/test_torch_formats_avif_write.py
# holds every other layer to PIL's save): the file's SHA-256 and that of
# its RGBA decode there
AVIF_WRITER_SIZES = {".avif": (48, 64)}
AVIF_WRITER_SHA256 = {
    ".avif L": "4a4019e720f275ce395a8e8f47f45bfd"
        "1a0d18cd34f0711840a75b0ce5584ac3",
    ".avif RGB": "b11ce6ea5840c1ca43cc6a54d32bdac3"
        "f8477abb4584e797fa7cd8309751b151",
    ".avif RGBA": "8aebe9c3617cb86b28af4220ce8bffae"
        "43e9a713c87b907c1349d84b7ed3edae"}
AVIF_WRITER_DECODED_SHA256 = {
    ".avif L": "e4318bfa1ea22198db49c3727cb9a6fe"
        "cef58295ff744971b0a33f73430b586a",
    ".avif RGB": "48b60c5577416259e65edf27713cea0b"
        "beafb8e4e3f79282c80b2cab27eab96b",
    ".avif RGBA": "3c28d3a0e62e53add608cc3ec71f517d"
        "e300403fa204c9724853a21b22dddfc6"}
# the port's AVIF saves of two courtyard textures (the one with an alpha
# item, and a 512 x 512 RGB map), and of their RGBA decodes, as above
COURTYARD_AVIF_WRITTEN = ("ivy_albedo", "stone_normal")
COURTYARD_AVIF_WRITTEN_SHA256 = {
    "ivy_albedo": "2daf9e1ae569d3a3008a8449a2fb331e"
        "45e0ac9716223e1da7dbae533ba7e08b",
    "stone_normal": "d08d23afda789fc50a75af0dd80a6c6c"
        "4228e8431172022ae070085d91e399b8"}
COURTYARD_AVIF_WRITTEN_DECODED_SHA256 = {
    "ivy_albedo": "88e966315920946d5a8f14c3e0f995e1"
        "364e461543eadb4a0ba75dc4a6707715",
    "stone_normal": "96c7fea934b00ad9685f37e2b6d06f9b"
        "984a1b30c8f511bb78b62b8e06b9f0b8"}
WRITER_CLOCK = 1_700_000_000
WRITER_SHA256 = {
    ".gif L": "74e9bd19791262110431acb607b32a66"
        "738519b4a2774156819d3a6fe4518e4d",
    ".gif RGB": "372d1d732b1ff18ae575abfb99e3f8fc"
        "f0192ae61503a9ca18745801b999823e",
    ".gif RGBA": "85b4ea816a198e2ddcd8579536fbb08c"
        "ca873eeb61cb229ed9910a6ff9d6962f",
    ".eps L": "1584657bf6187927b74c692a81917e94"
        "2352cd358f8bce4549964610cb0fac07",
    ".eps RGB": "96dd8f30d56a1edf7d0185c248f10e64"
        "18f7e51232bd7d0b8959471a87825a48",
    ".ps L": "1fcf41557381233ffd42b0f479a0cf21"
        "5efd7d7b15115be821e3fef6a7634183",
    ".ps RGB": "3a252c5997b5d5abac6139002ffa999a"
        "492b3430e1970140f6db37d2661d60de",
    ".pdf L": "c74b82c477132f2740aefec7cc1e46c3"
        "9836d9bccc235fc5bcc1ee6297720e05",
    ".pdf RGB": "3f62aaa255d90b7d2e31080725d2bf84"
        "113ba47f17f3f6c447cb9b3aca8f91f5",
    ".pdf RGBA": "7bb8439cdadb88b016d8d4e3de2ab0e2"
        "d582c1ed05510057d0a7c8e7559e3c72",
    ".mpo L": "5004c1f1f47821aab2cccb2decd55631"
        "06e3011a11db3e8e490ad6a00801bab2",
    ".mpo RGB": "3f2c96bd193760b2056719f9edca0917"
        "b47d545e012e5ad872683043e47c0fa7",
    ".ico L": "071e175709c267dd5e2d504b63a2d9df"
        "e198c283626906b36690c5dad87baf39",
    ".ico RGB": "d19be9af7fa9d72176306e6ea9538e90"
        "f612ae670c0582f154ecbacb2a7e10d0",
    ".ico RGBA": "827e9de575b6fba6241a726c3a8edf73"
        "388ef57ec5539952cb389b6131120ce4",
    ".icns L": "e8a4780fc294b996b9916083736a4fbb"
        "832300fb985e51dfbb9520d65f386fd6",
    ".icns RGB": "2fc42e69cd0b7c00acaa609e11ff02f2"
        "42adba436624e22546ba9a0382ab341f",
    ".icns RGBA": "eb36ca75d24ca159b642fc9cbea61259"
        "10a985fdd99bc01f32ddad1253f37e34",
    ".jp2 L": "701bebb3c949acf9c249f7d0d60521b5"
        "35b66dc848668bd298e0545f6f366ee1",
    ".jp2 RGB": "9646607d4fc3e64d20aa82a8e0ce64fe"
        "4fb3cb333fc1c2bca2772ab790d222cb",
    ".jp2 RGBA": "5d7a0fcca7dd3387e3b0dcb900d7488d"
        "ddf04c1e8cdc63812045bb610c9cc71a",
    ".j2k L": "d43edf9b02be4c152cf55ed8cde97dcb"
        "23ba6509cb3007818e2e973adc724b48",
    ".j2k RGB": "00d06361a6bc7dd9b1aceedec3e52e13"
        "70fd0990edd21a97154202653a0cddb1",
    ".j2k RGBA": "6416f94736bbb19558d80e15a84f4e5e"
        "2fa4ee1a676f1d99ae51ba7eb94fa279",
    ".webp L": "87d7bc8d324313c616472134ea041e87"
        "ba833bd0cec1b069f0c1fafa99d14729",
    ".webp RGB": "be5572249d61afa549f46f1d1dbd8391"
        "8f1ceeac3a56a399790d9cad33efedbf",
    ".webp RGBA": "cce13450f985d080b159a955b3a77b03"
        "2fe43ca518d6dc2a33e442bafbc73e9a"}
FORMAT_FRAMES = 3
# the courtyard's copies: a texture slot's file -> the suffix it is saved
# with (None: the committed PNG stays)
NORMAL_MAPS_ALPHA_FREE = {"ivy_normal": ".bmp", "metal_normal": ".bmp",
                          "stone_normal": ".ppm", "wood_normal": ".ppm"}
# SHA-256 of PIL's default JPEG save of the courtyard's four RGB maps
# (tests/test_torch_formats_more.py checks them against PIL); the port's
# save_image must write these bytes
COURTYARD_JPEG_SHA256 = {
    "ivy_normal": "cbdb59ddda618d33e00f7ef0050dd935"
                  "c8f8f6f826c2a6abadc16f92bef67da3",
    "metal_normal": "5688d28c4b70b678189090e99fca4a0f"
                    "274f6c0cf086d77f2c8dfc8fc7c9dad0",
    "stone_normal": "575890df350ecf0489538960bfe43c7b"
                    "5f6c5f87e434a12c39d9f41930f07946",
    "wood_normal": "cad015a94530e1508f0d79c4258d2250"
                   "afd9de115e7bd9d321a0478ad7a63a9d"}
# SHA-256 of PIL's default JPEG 2000 save as .jp2 of the courtyard's 12
# textures, the RGB normal maps kept RGB (tests/test_torch_formats_j2k_write.py
# checks them against PIL); the port's save_image must write these bytes
COURTYARD_JP2_WRITTEN_SHA256 = {
    "ivy_albedo": "fbca8667ea17fb4ded8a5ca55a9c452a"
                  "e9cb01cd3c776fdef1ab65a69cc0d08f",
    "ivy_mr": "26cd573c60622f82fad3ca8b3ffecc25"
              "75be7abce2c0653652d1880da7382806",
    "ivy_normal": "6ee02b4f9fdb3e9a3f48c4be3e33621a"
                  "3b3425f2d0a55b7b59beb91456f8cc13",
    "metal_albedo": "8ef4fedc605eee3033e12c6afe42c9b1"
                    "e693a620174220bd2512f60a12147c77",
    "metal_mr": "4759a4448d5b8817af9d9d20b8e51f3f"
                "31e3854f055618cb2a672dfdf7311df7",
    "metal_normal": "c88780765032c7e55672c644bce4a24d"
                    "b32bb3af2cad2a69acfe1472016d419a",
    "stone_albedo": "ecdda843d1f52dafb361865c02bfb98c"
                    "ef82c57ec00a9ad184fb3d5d5ff7daa3",
    "stone_mr": "ff3cf9188469270222f989d9c16d2952"
                "918b595bc54d2e03cb8c9c17935139bd",
    "stone_normal": "13daeb6d2687b46c1362bbc78c0b1eae"
                    "75499f96976030ceee345ca441ab6677",
    "wood_albedo": "c0ff6f8262294be605f05c566ce8d5c0"
                   "f7bc89543faa7bf20ef1f879e82553f2",
    "wood_mr": "10157adcfead00e9a85600030458fc92"
               "84c936461829e4240810c94af108e37d",
    "wood_normal": "ca0858441e8fa2f68411f80d9c8d5038"
                   "a057fcb404f2500519dee2a0d40931e7"}
# SHA-256 of PIL's default (lossy) WebP save of the courtyard's 12
# textures, the RGB normal maps kept RGB
# (tests/test_torch_formats_webp_write.py checks them against PIL); the
# port's save_image must write these bytes
COURTYARD_WEBP_WRITTEN_SHA256 = {
    "ivy_albedo": "f4e6d6e190baaa6f387ed829caab2e2a"
                  "e68c98829185d751c7c19819078b97c8",
    "ivy_mr": "49ebc845f1b780bf8afd95c325c6db03"
              "c99b73ee3acea8c1c2a076d8b9e3b14e",
    "ivy_normal": "ba1d8d1a68b14cc9dbf5403906fdd9f2"
                  "694abc465c1f45fefed3eccb1944dcb3",
    "metal_albedo": "957bee5f067931ca993ddbc4429daa8e"
                    "690d37598e4572ecd4587bd6d3d6faec",
    "metal_mr": "008c9fc34cf721a8f31906fc5733bc06"
                "7bd3dc44d25f3741c771c897283464c4",
    "metal_normal": "a4fdcb36a14138afe431d610be34f3e4"
                    "155f0cd27670939eb6e495c53df7bfa1",
    "stone_albedo": "7de5dddb8cf6b07de2b4862bee38c0d1"
                    "fed2046b8311fd7b75de83bfce74d7cf",
    "stone_mr": "1a0af4a95b5741403f817045d961e19a"
                "5d84ae52f23a5956576c8d6f7a732298",
    "stone_normal": "fb9e3efd070bf8b9e219e4820510adcc"
                    "b9241daee06e077e4561fb5d7f569528",
    "wood_albedo": "392e8aa3ec1e04ba9f26e8eef53a76f0"
                   "9938cd4eba09d406d5a3090643f4c594",
    "wood_mr": "853de402122c72f8c65fc16691c31d1d"
               "05b3e7bd20b84a35db09f5a62e7744af",
    "wood_normal": "4e9e260a73819706dc47d5a7236cf35d"
                   "3c92a125c609d08faf42d902137bb90c"}
# the copies formats_phase renders: kind -> (texture files written, frames
# and pool held bit-equal to the PNG courtyard's)
FORMAT_COPIES = {"tga": (12, True), "tif": (12, True), "bmp_ppm": (4, True),
                 "qoi": (12, True), "sgi": (12, True), "jpg": (4, False),
                 "im": (12, True), "jp2": (12, False),
                 "jp2_written": (12, True), "webp_written": (12, False),
                 "avif": (12, False), "htj2k": (12, False),
                 "avif_ycgco": (12, False)}
# the committed courtyard sets copied whole: kind -> (folder, suffix, the
# digests of PIL's decodes)
COURTYARD_SETS = {
    "jp2": (COURTYARD_JP2, ".jp2", COURTYARD_JP2_SHA256),
    "avif": (COURTYARD_AVIF, ".avif", COURTYARD_AVIF_SHA256),
    "htj2k": (COURTYARD_HTJ2K, ".j2k", COURTYARD_HTJ2K_SHA256),
    "avif_ycgco": (COURTYARD_AVIF_YCGCO, ".avif",
                   COURTYARD_AVIF_YCGCO_SHA256)}


def format_fixtures() -> dict:
    """Every committed fixture of tests/data/formats,
    tests/data/formats_legacy, tests/data/formats_codecs,
    tests/data/formats_j2k, tests/data/formats_bptc,
    tests/data/formats_avif, tests/data/formats_avif_matrix and
    tests/data/formats_htj2k through load_image
    (this machine has no PIL) equal to PIL's decode committed beside it as
    PNG (a .hdr file: to the JAX package's load_image result, as .npy),
    and its host wall time (the best of 3 loads)."""
    found = {}
    for folder, expected, prefix in (
            (FORMAT_FIXTURES, FORMAT_NAMES, ""),
            (LEGACY_FORMAT_FIXTURES, LEGACY_FORMAT_NAMES, "legacy/"),
            (CODECS_FORMAT_FIXTURES, CODECS_FORMAT_NAMES, "codecs/"),
            (J2K_FORMAT_FIXTURES, J2K_FORMAT_NAMES, "j2k/"),
            (BPTC_FORMAT_FIXTURES, BPTC_FORMAT_NAMES, "bptc/"),
            (AVIF_FORMAT_FIXTURES, AVIF_FORMAT_NAMES, "avif/"),
            (AVIF_MATRIX_FIXTURES, AVIF_MATRIX_NAMES, "avif_matrix/"),
            (HTJ2K_FORMAT_FIXTURES, HTJ2K_FORMAT_NAMES, "htj2k/")):
        names = tuple(sorted(p.name for p in folder.iterdir()
                             if p.is_file()
                             and not p.name.endswith((".png", ".npy"))))
        check(names == expected, f"the format fixtures of {folder.name}: "
                                 f"{names}")
        for name in names:
            if name.endswith(".hdr"):  # the JAX package's load_image
                want = np.load(folder / f"{name}.npy")
            else:
                want = image_io.load_image(folder / f"{name}.png")
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                got = image_io.load_image(folder / name)
                times.append((time.perf_counter() - t0) * 1e3)
            check(got.shape == want.shape and got.dtype == want.dtype
                  and np.array_equal(got, want),
                  f"{prefix}{name} equals PIL's decode (.hdr: the JAX "
                  f"package's load_image)")
            found[prefix + name] = dict(shape=list(got.shape),
                                        load_ms=min(times))
    print("format fixtures decoded equal to PIL's PNGs (host ms, best of "
          "3): " + json.dumps(found), flush=True)
    return found


def avif_hbd_fixtures() -> dict:
    """The 10 and 12-bit AVIF fixtures through load_image: each decoded to
    PIL's RGBA (its SHA-256 in AVIF_HBD_SHA256), or refused with
    ValueError where PIL refuses the file; prints this part's seconds."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in AVIF_HBD_FIXTURES.glob("*.avif"))
    check(names == sorted(AVIF_HBD_SHA256),
          f"the 10 / 12-bit AVIF fixtures: {names}")
    found = {}
    for name in names:
        t = time.perf_counter()
        try:
            img = image_io.load_image(AVIF_HBD_FIXTURES / f"{name}.avif")
            got = hashlib.sha256(np.ascontiguousarray(img).tobytes()
                                 ).hexdigest()
        except ValueError:
            got = None
        found[name] = dict(load_ms=(time.perf_counter() - t) * 1e3,
                           refused=got is None)
        check(got == AVIF_HBD_SHA256[name],
              f"avif_hbd/{name}.avif decodes to PIL's RGBA (SHA-256 "
              f"{AVIF_HBD_SHA256[name]}, the port's {got})")
    seconds = time.perf_counter() - t0
    print(f"10 / 12-bit AVIF fixtures ({len(names)}) equal to PIL's digests "
          f"in {seconds:.1f} s: " + json.dumps(found), flush=True)
    return dict(seconds=seconds, files=found)


def avif_superres_fixtures() -> dict:
    """The superres AVIF fixtures through load_image, each decoded to PIL's
    RGBA (its SHA-256 in AVIF_SUPERRES_SHA256); prints each read's host
    ms, the courtyard texture's on a line of its own."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in AVIF_SUPERRES_FIXTURES.glob("*.avif"))
    check(names == sorted(AVIF_SUPERRES_SHA256),
          f"the superres AVIF fixtures: {names}")
    found = {}
    for name in names:
        t = time.perf_counter()
        img = image_io.load_image(AVIF_SUPERRES_FIXTURES / f"{name}.avif")
        ms = (time.perf_counter() - t) * 1e3
        got = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        check(got == AVIF_SUPERRES_SHA256[name],
              f"avif_superres/{name}.avif decodes to PIL's RGBA (SHA-256 "
              f"{AVIF_SUPERRES_SHA256[name]}, the port's {got})")
        found[name] = dict(shape=list(img.shape), load_ms=ms)
    seconds = time.perf_counter() - t0
    print("courtyard texture saved as superres (wood albedo 200 x 128, "
          "coded 100 wide), read: " + json.dumps(found["courtyard_d16"]),
          flush=True)
    print(f"superres AVIF fixtures ({len(names)}) equal to PIL's digests in "
          f"{seconds:.1f} s (host ms each): " + json.dumps(found), flush=True)
    return dict(seconds=seconds, files=found)


def writer_image(suffix: str, mode: str) -> np.ndarray:
    """A seeded gradient-and-noise picture at WRITER_SIZES[suffix] in mode
    L, RGB or RGBA (a tenth of the RGBA pixels transparent)."""
    h, w = {**WRITER_SIZES, **AVIF_WRITER_SIZES}[suffix]
    c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    rng = np.random.default_rng(sum(map(ord, suffix + mode)))
    y, x = np.mgrid[0:h, 0:w]
    chans = [x * 255.0 / (w - 1), y * 255.0 / (h - 1), (x + 2 * y) * 5.0
             % 256, 255.0 - (x * y) % 200]
    a = np.stack(chans[:c], -1) + rng.normal(0, 12, (h, w, c))
    a = np.clip(a, 0, 255).astype(np.uint8)
    if c == 4:
        a[..., 3][rng.random((h, w)) < 0.1] = 0
    return a[..., 0] if c == 1 else a


def icon_digest(data: bytes, decode) -> str:
    """SHA-256 over an ICO's or ICNS's entries in file order: the ICO
    directory fields but size and offset, or the ICNS element type, then
    each PNG entry's colour type and its RGBA decode (`decode`: PNG bytes
    -> (H, W, 4) u8). The PNG bytes themselves are not PIL's: the port
    deflates with Python's zlib."""
    entries = []
    if data[:4] == b"icns":
        (total,) = struct.unpack_from(">i", data, 4)
        at = 8
        while at < total:
            kind, size = struct.unpack_from(">4si", data, at)
            if kind != b"TOC ":
                entries.append((kind, data[at + 8:at + size]))
            at += size
    else:
        (n,) = struct.unpack_from("<H", data, 4)
        for i in range(n):
            d = data[6 + 16 * i:22 + 16 * i]
            size, offset = struct.unpack_from("<II", d, 8)
            entries.append((d[:8], data[offset:offset + size]))
    h = hashlib.sha256()
    for head, png in entries:
        h.update(head + png[25:26])
        h.update(np.ascontiguousarray(decode(png)).tobytes())
    return h.hexdigest()


def format_writers(tmp: Path) -> dict:
    """save_image's GIF, EPS, PS, PDF, MPO, ICO, ICNS and JPEG 2000 writers on
    writer_image's arrays (this machine has no PIL): each file's digest
    equal to PIL's save of the same array (WRITER_SHA256; PDFs written
    with time.gmtime frozen at WRITER_CLOCK), the modes PIL refuses raising
    ValueError with no file written, and the host wall time of each write
    (the best of 3)."""
    from unittest import mock

    clock = time.gmtime(WRITER_CLOCK)
    found = {}
    for suffix in WRITER_SIZES:
        for mode in ("L", "RGB", "RGBA"):
            img = writer_image(suffix, mode)
            path = tmp / f"writer_{mode.lower()}{suffix}"
            if mode in WRITER_REFUSED.get(suffix, ()):
                try:
                    image_io.save_image(path, img)
                    refused = False
                except ValueError:
                    refused = True
                check(refused and not path.exists(),
                      f"save_image refuses {mode} as {suffix}, as PIL does")
                continue
            times = []
            with mock.patch.object(time, "gmtime", lambda *a: clock):
                for _ in range(3):
                    t0 = time.perf_counter()
                    image_io.save_image(path, img)
                    times.append((time.perf_counter() - t0) * 1e3)
            data = path.read_bytes()
            if suffix in (".ico", ".icns"):
                digest = icon_digest(data, image_io.decode_png)
            else:
                digest = hashlib.sha256(data).hexdigest()
            key = f"{suffix} {mode}"
            check(digest == WRITER_SHA256[key],
                  f"save_image {key}: PIL's save ({digest})")
            found[key] = dict(shape=list(img.shape), bytes=len(data),
                              save_ms=min(times))
    print("writers equal to PIL's saves (host ms, best of 3): "
          + json.dumps(found), flush=True)
    for suffix in AVIF_WRITER_SIZES:
        for mode in ("L", "RGB", "RGBA"):
            key = f"{suffix} {mode}"
            path = tmp / f"writer_{mode.lower()}{suffix}"
            t0 = time.perf_counter()
            image_io.save_image(path, writer_image(suffix, mode))
            ms = (time.perf_counter() - t0) * 1e3
            found[key] = avif_check(path, ms, AVIF_WRITER_SHA256[key],
                                    AVIF_WRITER_DECODED_SHA256[key], key)
    return found


def avif_check(path: Path, encode_ms: float, digest: str, decoded: str,
               what: str) -> dict:
    """A file the port's AVIF writer wrote: its SHA-256 equal to the one
    written on the development host, the port's decode of it equal to the
    decode there, and its encode and decode host ms."""
    data = path.read_bytes()
    got = hashlib.sha256(data).hexdigest()
    check(got == digest, f"AVIF {what} written as on the development host "
          f"({got})")
    t0 = time.perf_counter()
    img = image_io.load_image(path)
    decode_ms = (time.perf_counter() - t0) * 1e3
    got = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
    check(got == decoded, f"AVIF {what} decodes as on the development host "
          f"({got})")
    out = dict(bytes=len(data), encode_ms=encode_ms, decode_ms=decode_ms)
    print(f"AVIF {what} written by the port: {json.dumps(out)}", flush=True)
    return out


def avif_written(tmp: Path) -> dict:
    """The port's AVIF saves of COURTYARD_AVIF_WRITTEN (RGB normal maps kept
    RGB), each against the development host's bytes and decode."""
    found = {}
    for stem in COURTYARD_AVIF_WRITTEN:
        img = image_io.load_image(ROOT / "assets" / "demo" / f"{stem}.png")
        if "normal" in stem and (img[..., 3] == 255).all():
            img = img[..., :3]
        path = tmp / f"{stem}.avif"
        t0 = time.perf_counter()
        image_io.save_image(path, img)
        ms = (time.perf_counter() - t0) * 1e3
        found[stem] = avif_check(path, ms, COURTYARD_AVIF_WRITTEN_SHA256[stem],
                                 COURTYARD_AVIF_WRITTEN_DECODED_SHA256[stem],
                                 stem)
    return found


def courtyard_copy(tmp: Path, kind: str) -> tuple[Path, list, dict]:
    """A .plain of the courtyard whose texture files are re-saved by the
    port's save_image under tmp: kind "tga", "tif", "qoi", "sgi", "im",
    "jp2_written", "webp_written" or "avif_written" (all 12; the last
    three as .jp2, .webp and .avif), "bmp_ppm" (the four RGB normal
    maps as two BMP and two PPM, the RGBA maps left as PNG) or "jpg" (the
    four RGB maps as JPEG); kinds "jp2", "avif", "htj2k" and "avif_ycgco"
    copy the 12 committed files of COURTYARD_SETS (PIL's lossy JP2 and
    default AVIF saves, the HTJ2K 9/7 codestreams, the YCgCo 4:2:0 AVIF
    files libavif writes).
    The SDF volume paths stay
    as committed. Also each written file's save_image wall time in ms."""
    from plainrenderer_tpu_torch.assets import plain_format

    scene = plain_format.load_binary_scene(COURTYARD)
    written = []
    save_ms = {}
    meshes = []
    for mesh in scene.meshes:
        paths = {}
        for slot in ("albedo", "normal", "specular"):
            src = Path(getattr(mesh.texture_paths, slot))
            if kind == "bmp_ppm":
                suffix = NORMAL_MAPS_ALPHA_FREE.get(src.stem)
            elif kind == "jpg":
                suffix = ".jpg" if src.stem in COURTYARD_JPEG_SHA256 else None
            elif kind in ("jp2_written", "webp_written", "avif_written"):
                suffix = "." + kind.split("_")[0]
            else:
                suffix = "." + kind
            if suffix is None:
                paths[slot] = str(src)
                continue
            if kind in COURTYARD_SETS:
                folder, suffix, _ = COURTYARD_SETS[kind]
                dst = tmp / (src.stem + suffix)
                shutil.copyfile(folder / dst.name, dst)
                paths[slot] = str(dst)
                written.append(dst.name)
                continue
            img = image_io.load_image(src)
            if slot == "normal":  # the RGB maps stay RGB
                check(bool((img[..., 3] == 255).all()),
                      f"{src.name} is opaque")
                img = img[..., :3]
            dst = tmp / (src.stem + suffix)
            t0 = time.perf_counter()
            image_io.save_image(dst, img)
            save_ms[dst.name] = (time.perf_counter() - t0) * 1e3
            paths[slot] = str(dst)
            written.append(dst.name)
        meshes.append(dataclasses.replace(
            mesh, texture_paths=dataclasses.replace(mesh.texture_paths,
                                                    **paths)))
    out = tmp / "courtyard.plain"
    plain_format.save_binary_scene(out, dataclasses.replace(scene,
                                                            meshes=meshes))
    return out, written, save_ms


def format_frames(ctx, scene_path) -> dict:
    """The App at 1920x1080 with main()'s settings on a courtyard .plain:
    its load time, its texture pool on the host, and FORMAT_FRAMES
    run_frames at a fixed delta time and orbit input."""
    from plainrenderer_tpu_torch.runtime.shell import InputState

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    app = runtime_app(ctx.dev, WIDTH, HEIGHT, scene_path=str(scene_path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_tex = courtyard_textures_reach_the_pool(app, str(scene_path))
    app.timer = types.SimpleNamespace(mark_new_frame=lambda: None,
                                      delta_time=1.0 / 60.0)
    pool = {k: app.scene[k].cpu().numpy() for k in (
        "mat_tex", "tex_info", "tex_word0", "tex_word1", "alpha_masks")
        if k in app.scene}
    images = [app.run_frame(InputState(right_mouse_down=True,
                                       mouse_movement=(20.0 / 60.0, 0.0)))
              .cpu().numpy() for _ in range(FORMAT_FRAMES)]
    del app
    torch.cuda.empty_cache()
    return dict(load_s=load_s, textures=n_tex, pool=pool, images=images)


def jp2_decodes(folder: Path, names, digests=None, what="JP2") -> dict:
    """Each courtyard JP2 (or AVIF) decoded on the host: its RGBA digest
    equal to PIL's decode's (COURTYARD_JP2_SHA256 / COURTYARD_AVIF_SHA256),
    and its wall time in ms."""
    digests = COURTYARD_JP2_SHA256 if digests is None else digests
    times = {}
    for name in names:
        t0 = time.perf_counter()
        img = image_io.load_image(folder / name)
        times[name] = (time.perf_counter() - t0) * 1e3
        digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        check(digest == digests[Path(name).stem],
              f"courtyard {name} decodes to PIL's RGBA ({digest})")
    print(f"courtyard {what} decodes equal to PIL's (host ms): "
          + json.dumps(times), flush=True)
    return times


def courtyard_written(folder: Path, names, save_ms: dict, digests: dict,
                      what: str) -> dict:
    """The courtyard's textures as the port wrote them (as JP2 or WebP):
    each file's SHA-256 equal to PIL's save of the same array (digests),
    its host encode ms (save_image) and decode ms (load_image) and its
    size."""
    found = {}
    for name in names:
        data = (folder / name).read_bytes()
        digest = hashlib.sha256(data).hexdigest()
        check(digest == digests[Path(name).stem],
              f"courtyard {name} written as PIL writes it ({digest})")
        t0 = time.perf_counter()
        image_io.load_image(folder / name)
        found[name] = dict(bytes=len(data), encode_ms=save_ms[name],
                           decode_ms=(time.perf_counter() - t0) * 1e3)
    print(f"courtyard {what} written equal to PIL's saves (host ms): "
          + json.dumps(found), flush=True)
    return found


def formats_phase(ctx) -> dict:
    """The image readers and writers on the card's machine (no PIL): the
    committed fixtures (PIL's legacy formats, the TIFF codecs and JPEG
    modes, JPEG 2000, BC6H, BC7 and Radiance among them), the writers of
    GIF, EPS / PS, PDF, MPO, ICO, ICNS, JPEG 2000 and WebP against PIL's
    saves, then the courtyard with its textures re-saved as TGA, TIFF,
    QOI, SGI, IM and JP2 (the JP2 files byte for byte PIL's saves: their
    digests), and with BMP / PPM normal maps, each loaded by
    the App and rendered (kernels A-L on the card) equal bit for bit,
    pool and frames, to the committed PNG courtyard's run; with its
    four RGB maps written as JPEG, byte for byte PIL's (their digests),
    with all 12 textures as the committed JP2 files, each decoded to
    PIL's RGBA (their digests), with all 12 written as WebP (lossy),
    byte for byte PIL's saves (their digests), and with all 12 as the
    committed AVIF files, as HTJ2K 9/7 codestreams and as YCgCo 4:2:0
    AVIF, each decoded to PIL's RGBA (their digests), each loaded with all
    12 slots and rendered to frames that are neither black nor white; and
    the AVIF fixtures rewritten to 10 and 12 bits and the superres AVIF
    fixtures decoded to PIL's RGBA (their digests)."""
    import tempfile

    t_phase = time.perf_counter()
    found = dict(fixtures=format_fixtures(), avif_hbd=avif_hbd_fixtures(),
                 avif_superres=avif_superres_fixtures())
    with tempfile.TemporaryDirectory() as tmp:
        found["writers"] = format_writers(Path(tmp))
        found["avif_written"] = avif_written(Path(tmp))
    base = format_frames(ctx, COURTYARD)
    check(base["textures"] == 12, "the PNG courtyard's 12 texture slots")
    loads = {"png": base["load_s"]}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, (n_written, equal) in FORMAT_COPIES.items():
            sub = Path(tmp) / kind
            sub.mkdir()
            plain, written, save_ms = courtyard_copy(sub, kind)
            check(len(written) == n_written,
                  f"courtyard as {kind}: textures written {written}")
            if kind == "jpg":
                digests = {Path(n).stem: hashlib.sha256(
                    (sub / n).read_bytes()).hexdigest() for n in written}
                check(digests == COURTYARD_JPEG_SHA256,
                      f"courtyard maps as JPEG: the bytes of PIL's save "
                      f"({digests})")
            if kind in COURTYARD_SETS:
                found[f"{kind}_decode_ms"] = jp2_decodes(
                    sub, written, COURTYARD_SETS[kind][2], kind)
            if kind == "jp2_written":
                found[kind] = courtyard_written(
                    sub, written, save_ms, COURTYARD_JP2_WRITTEN_SHA256,
                    "JP2")
            if kind == "webp_written":
                found[kind] = courtyard_written(
                    sub, written, save_ms, COURTYARD_WEBP_WRITTEN_SHA256,
                    "WebP")
            run = format_frames(ctx, plain)
            check(run["textures"] == 12,
                  f"courtyard as {kind}: all 12 texture slots load")
            loads[kind] = run["load_s"]
            if not equal:
                check(all(img.shape == base["images"][0].shape
                          and img.dtype == base["images"][0].dtype
                          and 0 < float(img.mean()) < 255
                          for img in run["images"]),
                      f"courtyard as {kind}: {FORMAT_FRAMES} frames of the "
                      f"PNG courtyard's shape, neither black nor white")
                continue
            for key, want in base["pool"].items():
                got = run["pool"].get(key)
                check(got is not None and got.shape == want.shape
                      and np.array_equal(got, want),
                      f"courtyard as {kind}: texture pool {key} equals the "
                      f"PNG courtyard's")
            for i, (got, want) in enumerate(zip(run["images"],
                                                base["images"])):
                diff = np.argwhere((got != want).any(axis=-1))
                check(diff.size == 0,
                      f"courtyard as {kind}: frame {i} equals the PNG "
                      f"courtyard's bit for bit ({len(diff)} pixels differ, "
                      f"first at {diff[:3].tolist()})")
    found.update(scene_load_s=loads, frames=FORMAT_FRAMES,
                 phase_s=time.perf_counter() - t_phase)
    print(f"courtyard scene load at {WIDTH}x{HEIGHT} (s, App() with the "
          f"texture decodes): {json.dumps(loads)}; {FORMAT_FRAMES} frames "
          f"each, equal to the PNG courtyard's with equal texture pools "
          f"except jpg, jp2, webp_written, avif, htj2k and avif_ycgco "
          f"(lossy; their digests "
          f"equal PIL's); phase "
          f"{found['phase_s']:.1f} s", flush=True)
    return found


# ------------------------- row 8: split-frame bands -------------------------

# 4 ranks on the one card, over gloo with host-staged collectives (NCCL
# refuses two ranks on one device); bench.py's scene at the frame that
# band_settings gives for bench.py's 1920x1080 and 4 bands: 4 x 256 rows.
# Bands tile the single-device frame only where the band height is a
# multiple of 32 rows (the GI's half-resolution rows must fill whole
# 16-row tiles and the fog's coarse grid whole rows: the JAX package's
# band semantics, kept; tests/test_torch_bands.py measures the drift at
# 144-row bands), so 1920x1088 (272-row bands) is not a height this row
# can hold to the single-device frame.
BAND_RANKS, BAND_FRAMES, BAND_HEIGHT = 4, 3, 1024
BAND_CHECK_RANK = 1  # a band with two real halos
BAND_VARIANT = "band (rank 1 of 4)"
BAND_KERNELS = ("expand_keys", "depth", "depth_alpha", "gbuffer",
                "winner_alpha", "attr_resolve")
# the rule: the looser of tests/test_parallel.py's fog and GI rules (both
# are on): within 2 LSB, above 12 LSB, the seam rows within 2 LSB
BAND_RULE = dict(within2=0.965, above12=5e-3, seam_within2=0.97)


def band_settings_at(scale: float):
    """The default RenderSettings() at 1920 x BAND_HEIGHT."""
    return dataclasses.replace(config.RenderSettings(), width=WIDTH,
                               height=BAND_HEIGHT, pair_budget_scale=scale)


def band_kernels(ctx, atlas, mv, settings) -> dict:
    """Kernels A, E and J on this rank's band of atlas bins (A's keys of
    the band slice, decoded from view_row0; E on the band's opaque
    casters; J's alpha casters merged on E's band) and B, K and L on the
    band view, each against its plain version and timed as BAND_VARIANT
    (the other ranks wait at a barrier)."""
    n_cas = settings.shadows.cascade_count
    check(atlas.view_row0 is not None and int(atlas.overflow) == 0,
          "band atlas: a band of bins, nothing dropped")
    ki = raster.pair_key_inputs(atlas.band_setup, atlas.n_bins_y,
                                atlas.n_bins_x, atlas.pair_budget, atlas.sub,
                                order_rows=True, n_views=n_cas, band=True)
    live, bound = check_keys(
        ki, f"kernel A ({BAND_VARIANT}: atlas bins from row "
        f"{atlas.view_row0}, {atlas.n_bins_y} rows, {atlas.rows_per_view} "
        "per cascade)", "T/view")
    ctx.kernel("expand_keys", lambda: raster.expand_keys(ki), 50,
               lambda: raster.expand_keys_plain(ki), 10, bound, 0.0)
    found = dict(atlas_band_row0=atlas.view_row0,
                 atlas_band_bins=atlas.n_bins_y, atlas_band_live_pairs=live)
    found.update(check_and_time_e(ctx, atlas, n_cas, variant=BAND_VARIANT))
    jkl = check_and_time_jkl(ctx, None, settings, f" ({BAND_VARIANT})",
                             atlas=atlas, mv=mv, variant=BAND_VARIANT)
    main = jkl.pop("main")
    jkl.pop("mv")
    check_and_time_b(ctx, mv, main.pairs, main.pair_edges, main.pair_attrs,
                     what=f"kernel B ({BAND_VARIANT})", variant=BAND_VARIANT)
    found.update(jkl)
    return found


def band_rank(group, path: str, settings, n_frames: int) -> dict:
    """One rank of the band phase (comm.launch spawns it): bench.py's
    scene, the LUTs and the camera path loaded onto the rank's card,
    n_frames frames of its band. Frame 0 runs with the main view's setup
    and the atlas recorded; then rank BAND_CHECK_RANK holds A, B, E, J, K
    and L to their plain versions on them while the others wait at a
    barrier; the other frames are timed: CUDA events, host wall,
    collectives and their ms, host-staged copies, host syncs (sync debug
    mode), peak memory, launches. If any rank dropped pairs, every rank
    doubles pair_budget_scale and renders again."""
    import torch.distributed as dist

    from plainrenderer_tpu_torch.parallel import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = group.device
    data = torch.load(path, map_location=dev, weights_only=False)
    scene, luts, cam = data["scene"], data["luts"], data["cam"]
    native.library()
    ctx = Ctx(dev)
    ctx.path = f"band phase, rank {group.rank} of {group.size}"
    ctx.tag = BAND_VARIANT
    while True:
        run, bset = sharding.sharded_frame_fn(settings, group.size)
        state = sharding.initial_sharded_state(settings, group.size,
                                               device=dev)
        kept = []
        render_atlas = frame.render_shadow_atlas

        def keep_atlas(*args, **kw):
            kept.append(render_atlas(*args, **kw))
            return kept[-1]
        frame.render_shadow_atlas = keep_atlas
        try:
            with recorded_calls([(frame, "raster_main_view")]) as rec:
                image, state = run(group, state, scene, cam, luts,
                                   1.0 / 60.0)
        finally:
            frame.render_shadow_atlas = render_atlas
        counters = [state.debug_counters]
        dist.barrier()
        found = {}
        if group.rank == BAND_CHECK_RANK:
            found = band_kernels(ctx, kept[0], rec["raster_main_view"][0][0],
                                 bset)
        del kept, rec
        dist.barrier()
        torch.cuda.synchronize()
        native.reset_launch_counts()
        group.reset_stats()
        torch.cuda.reset_peak_memory_stats(dev)
        events, host_ms = [], []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            for _ in range(n_frames - 1):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                t0 = time.perf_counter()
                ev[0].record()
                image, state = run(group, state, scene, cam, luts,
                                   1.0 / 60.0)
                ev[1].record()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                events.append(ev)
                counters.append(state.debug_counters)
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        timed = n_frames - 1
        syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)
        stats = {k: v / timed for k, v in group.stats.items()}
        counters = torch.stack(counters)
        dropped = group.max_(counters.max().reshape(1).float())
        if float(dropped) == 0.0:
            break
        print(f"band rank {group.rank}: pairs dropped at "
              f"pair_budget_scale {settings.pair_budget_scale}", flush=True)
        settings = dataclasses.replace(
            settings, pair_budget_scale=2.0 * settings.pair_budget_scale)
        check(settings.pair_budget_scale <= 64.0, "band budget bounded")
    return dict(
        rank=group.rank, transport=group.transport,
        pair_budget_scale=settings.pair_budget_scale,
        image=image.cpu(), counters=counters.cpu().numpy(),
        frame_ms=[a.elapsed_time(b) for a, b in events], host_ms=host_ms,
        collectives_per_frame=stats["collectives"],
        collective_ms_per_frame=stats["ms"],
        host_copies_per_frame=stats["host_copies"],
        host_syncs_per_frame=syncs / timed,
        peak_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        launches=native.launch_counts(), timed_frames=timed,
        variants=ctx.variants, found=found)


def gloo_cuda_support(group) -> dict:
    """Which gloo collectives take CUDA tensors on this PyTorch: each
    tried once on a CUDA tensor, its outcome reported (comm.py stages
    every gloo collective through the host whatever this says)."""
    import torch.distributed as dist

    x = torch.ones(4, device=group.device)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(group.size)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * group.size, device=x.device), x),
        "barrier": dist.barrier}
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except Exception as err:  # reported, nothing is chosen by it
            out[name] = f"{type(err).__name__}: " \
                f"{str(err).strip().splitlines()[0][:160]}"
    return out


def band_small_card_vs_cpu(ctx) -> float:
    """4 bands of the small textured atrium at 128 x 256 (64-row bands;
    tests/test_parallel.py's GI settings: SDF GI at 8 steps, fog, TAA,
    bloom, the banded atlas at 512-px maps; the scene SDF baked on the
    card at 16^3 per mesh), 2 frames on 4 gloo ranks on the card and on 4
    gloo CPU ranks, by the golden rule."""
    from plainrenderer_tpu_torch.parallel import comm, sharding

    data = procedural.build_atrium_scene(procedural.AtriumConfig(
        **SMALL_ATRIUM))
    rs = scenebuild.build_render_scene(data)
    gsdf = sdf_scene.build_scene_sdf(rs, data, bake_resolution_cap=16,
                                     device=ctx.dev)
    scene = frame.attach_global_sdf(frame.scene_to_device(rs, device="cpu"),
                                    gsdf)
    settings = config.RenderSettings(
        width=128, height=256, exposure_adaption_speed=1000.0,
        shadows=config.ShadowSettings(resolution=512),
        sdf_trace=config.SDFTraceSettings(enabled=True, trace_steps=8))
    ext = cam_mod.extrinsic_from_angles([0.0, -1.7, 0.0], pitch_deg=5.0,
                                        yaw_deg=20.0)
    cam = frame.camera_arrays(ext.position, ext.forward, ext.right, ext.up,
                              device="cpu")
    luts = {k: v.cpu() for k, v in ctx.luts.items()}
    images = []
    for d in ("cuda", "cpu"):
        runs = comm.launch(sharding.render_bands, BAND_RANKS,
                           args=(settings, scene, cam, luts, 2), device=d,
                           timeout=600.0, pg_timeout=300.0)
        for r in runs:
            check((r["debug_counters"] == 0).all(),
                  f"small band frame on {d}: debug_counters [0, 0]")
        images.append(sharding.assemble_image(
            torch.stack([r["image"] for r in runs])))
        print(f"small band frame on {d}: ranks over {runs[0]['transport']}",
              flush=True)
    close = golden_close(*images)
    print(f"small band frame (128 x 256, 4 bands) card vs CPU ranks: "
          f"{close:.5f} of pixels within 2 LSB (limit > 0.999)", flush=True)
    check(close > 0.999, "small band frame card vs CPU ranks")
    return close


def band_phase(ctx) -> dict:
    """Row 8: bench.py's scene in BAND_RANKS bands at 1920 x BAND_HEIGHT
    on the one card (band_rank), against the parent's single-device render
    of the same BAND_FRAMES frames by BAND_RULE, seams included; every
    rank's debug_counters [0, 0], its launches of every kernel of the
    path, host syncs only the host-staged copies; rank 1's A, B, E, J, K
    and L against their plain versions; the small band frame card vs
    CPU ranks. 4 ranks sharing one H100 measure correctness and the
    collectives' cost, not a speed-up across cards; the NCCL path (one
    card per rank) does not run on a one-card machine."""
    import tempfile

    from plainrenderer_tpu_torch.parallel import comm

    t0 = time.time()
    support = comm.launch(gloo_cuda_support, 2, device="cuda", timeout=120.0,
                          pg_timeout=30.0)[0]
    print("gloo on CUDA tensors (torch "
          f"{torch.__version__}): " + json.dumps(support), flush=True)
    scene = ctx.scenes["bench"]
    tmp = Path(tempfile.mkdtemp(prefix="plain_band_phase_"))
    path = tmp / "inputs.pt"
    torch.save(dict(scene=scene, luts=ctx.luts, cam=ctx.cam_path), path)
    backend = comm.pick_backend(BAND_RANKS, "cuda")
    print(f"band phase: {BAND_RANKS} ranks on {torch.cuda.device_count()} "
          f"card(s), backend {backend}; 1920 x {BAND_HEIGHT} in bands of "
          f"{BAND_HEIGHT // BAND_RANKS} rows, {BAND_FRAMES} frames", flush=True)
    try:
        runs = comm.launch(band_rank, BAND_RANKS,
                           args=(str(path), band_settings_at(ctx.scale),
                                 BAND_FRAMES), device="cuda", timeout=900.0,
                           pg_timeout=600.0)
    finally:
        path.unlink(missing_ok=True)
        tmp.rmdir()
    scale = runs[0]["pair_budget_scale"]
    settings = band_settings_at(scale)
    state = initial_state(WIDTH, BAND_HEIGHT, device=ctx.dev)
    for _ in range(BAND_FRAMES):
        single, state = frame.render_frame(state, scene, ctx.cam_path,
                                           ctx.luts, 1.0 / 60.0, settings,
                                           device=ctx.dev)
    check(state.debug_counters.tolist() == [0, 0],
          "band phase: the single-device frame drops nothing")
    single = single.cpu().numpy()
    bands = np.concatenate([r["image"].numpy() for r in runs])
    diff = np.abs(single.astype(np.int32) - bands.astype(np.int32))
    bh = BAND_HEIGHT // BAND_RANKS
    seam_rows = [y for b in range(1, BAND_RANKS) for y in (b * bh - 1,
                                                          b * bh)]
    found = dict(
        ranks=BAND_RANKS, frames=BAND_FRAMES, height=BAND_HEIGHT,
        transport=runs[0]["transport"], pair_budget_scale=scale,
        within2=float((diff <= 2).mean()),
        above12=float((diff > 12).mean()),
        seam_within2=float((diff[seam_rows] <= 2).mean()),
        seam_rows=seam_rows, max_diff=int(diff.max()), rule=BAND_RULE)
    print(f"band phase: the {BAND_RANKS}-band image against the "
          f"single-device one: {found['within2']:.5f} within 2 LSB (limit > "
          f"{BAND_RULE['within2']}), {found['above12']:.2e} above 12 LSB "
          f"(limit < {BAND_RULE['above12']}), seam rows {seam_rows} "
          f"{found['seam_within2']:.5f} within 2 LSB (limit > "
          f"{BAND_RULE['seam_within2']}); max {found['max_diff']}",
          flush=True)
    check(found["within2"] > BAND_RULE["within2"]
          and found["above12"] < BAND_RULE["above12"]
          and found["seam_within2"] > BAND_RULE["seam_within2"],
          "band phase: the bands meet the single-device frame")
    check(bands.std() > 5.0, "band phase: the image is not empty")
    per_rank = []
    for r in runs:
        check((r["counters"] == 0).all(),
              f"band rank {r['rank']}: debug_counters all [0, 0]: "
              f"{r['counters'].tolist()}")
        for name, k in _BENCH.items():
            check(r["launches"][name] >= k * r["timed_frames"],
                  f"band rank {r['rank']}: kernel {name} launched {k}x per "
                  f"frame ({r['launches'][name]} in {r['timed_frames']})")
        check(r["host_syncs_per_frame"] <= r["collectives_per_frame"],
              f"band rank {r['rank']}: host syncs only the host-staged "
              "copies to the host, one per collective")
        line = {k: r[k] for k in (
            "rank", "transport", "frame_ms", "host_ms",
            "collectives_per_frame", "collective_ms_per_frame",
            "host_copies_per_frame", "host_syncs_per_frame",
            "peak_allocated_gb")}
        line["launches_per_frame"] = {
            k: v / r["timed_frames"] for k, v in r["launches"].items() if v}
        print("band rank " + json.dumps(line), flush=True)
        per_rank.append(line)
    checked = runs[BAND_CHECK_RANK]
    for name, by_variant in checked["variants"].items():
        ctx.variants.setdefault(name, {}).update(by_variant)
    ctx.extra["band_launches"] = {
        name: checked["launches"][name] for name in BAND_KERNELS}
    ctx.extra["band_timed_frames"] = checked["timed_frames"]
    found.update(gloo_cuda_support=support, per_rank=per_rank,
                 checked_rank=BAND_CHECK_RANK,
                 checked=checked["found"],
                 small_card_vs_cpu=band_small_card_vs_cpu(ctx),
                 phase_s=time.time() - t0)
    print(f"band phase: {found['phase_s']:.1f} s", flush=True)
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
# with the supersampling pre-pass I and H run twice a frame
_PRE_PASS = dict(_BENCH, history_taps=2, packed_planes=2)
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
    # bench.py's scene with the TAA supersampling pre-pass: I on the
    # previous colour (K = 1) and H on its (luminance, depth) pair (P = 1)
    # beside their default uses; after its run the same frames as a flight
    Row(7, "bench", 3, 8, _PRE_PASS, slice7_kernels,
        lambda ctx, frames, settings, run: dict(flight=flight_phase(
            ctx, frames, settings, run, _PRE_PASS, "slice 7")),
        pick_scale=True,
        histories=dict(_HISTORIES, taa_luminance=lambda x: (x,)),
        branches=dict(history_taps=PRE_PASS_I, packed_planes=PRE_PASS_H)),
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
    ctx.path = "runtime (courtyard)"
    ctx.report["runtime"] = runtime_phase(ctx)
    ctx.path = "modules"
    ctx.report["modules"] = modules_phase(ctx)
    ctx.path = "formats (courtyard as TGA, TIFF, BMP / PPM)"
    ctx.report["formats"] = formats_phase(ctx)
    ctx.path = "band phase (bench scene)"
    ctx.report["band"] = band_phase(ctx)
    runtime_launches = ctx.report["runtime"]["launches"]

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
        # the runtime's courtyard run (App.run_frame, RUNTIME_TIMED frames)
        entry["launches_on"] += (f"; App.run_frame on the courtyard: "
                                 f"{runtime_launches[name]} over "
                                 f"{RUNTIME_TIMED} frames")
        entry["courtyard_launches"] = runtime_launches[name]
        if name in ctx.variants:  # other branches of the same kernel
            entry["variants"] = [dict(variant=v, **launched(name, v), **r)
                                 for v, r in ctx.variants[name].items()]
            for v in entry["variants"]:
                if v["variant"] == "courtyard":
                    v.update(launches=runtime_launches[name],
                             launches_on="App.run_frame on the courtyard")
                if v["variant"] in (PRE_PASS_I, PRE_PASS_H):
                    v["launches_on"] += (": the pre-pass's launch and the "
                                         "default use's, 2 a frame")
                if v["variant"] == BAND_VARIANT:
                    v.update(launches=ctx.extra["band_launches"][name],
                             launches_on=(
                                 f"band phase: rank {BAND_CHECK_RANK} of "
                                 f"{BAND_RANKS}, "
                                 f"{ctx.extra['band_timed_frames']} frames"))
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
