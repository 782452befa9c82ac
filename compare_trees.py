#!/usr/bin/env python3
"""Compare checkouts of the PyTorch/CUDA port on slice 5's frame, in
alternating order, on one NVIDIA GPU.

    python3 compare_trees.py --tree parent=DIR --tree change=DIR \
        --order parent,change,change,parent [--warmup 3 --timed 16]

Each entry of --order runs in a process of its own that imports the port
and chip_smoke.py of that checkout (so each tree runs its own kernels and
wrappers), builds bench.py's own scene (chip_smoke.SCENES["bench"]: the
textured atrium with its banners and its scene SDF) at 1920x1080 with the
default RenderSettings() and pair_budget_scale 2.0, and drives
warmup + timed frames on the bench camera path (chip_smoke.drive). It then
times, on frame 0's inputs, kernels E (rasterize_depth on the opaque
casters), J (rasterize_depth merging the atlas's alpha casters into a
clone of E's atlas), B (rasterize_gbuffer on the opaque main view), D
(sample_materials on the G-buffer, with the frame's keywords and again
trilinear + anisotropic and trilinear, texture_filter 2 and 1), F
(resolve_packed on the shadow inputs), G (trace_gi on the trace inputs),
K (rasterize_winner_alpha on the main view's alpha stream), L
(resolve_attributes on K's vis), I (history_taps at K = 1 on frame 1's
TAA history and coords, the first frame whose history holds an image;
its bits also at K = 16, tech 1's coords of the same motion), H
(packed_planes on frame 1's GI history and its reprojected coords)
and A (expand_keys on each of frame 0's four pair streams: the main
view's alpha and opaque streams, the atlas's opaque and alpha casters,
in the frame's order), on the device with chip_smoke.cuda_ms of
THIS checkout (CUDA events behind torch.cuda._sleep), with each tree's
own wrapper; each time comes with the host's enqueue per call (host us).
G's host time is also split into its argument set-up
(sdfgi._trace_setup) and the launch of sdfgi_trace_launch alone. The work
of the two alpha streams (chip_smoke.stream_counts of THIS checkout:
pairs, bins with pairs, median and largest pairs per bin, pixels of the
16 x 16 blocks that pass the corner test) is reported per process. Every
tree must give the same bits from E (the atlas), J (the merged atlas), G
(its 7 planes), K (depth and vis), L (its 13 channels), I (its 4 planes
at K = 1, 49 at K = 16), H (its 7 planes) and A (each stream's keys and
owners): each equals its plain version exactly today. The G-buffer's, D's and F's checksums are
reported per run (B, D and F have rules that allow a difference from
their plain versions, which chip_smoke.py checks, so trees may differ
there). Alternating the
order separates a tree's effect from drift over the call. Prints one JSON
line per process and a summary, and writes the report to
chiprun_out/compare_trees/report.json; then exits non-zero if E's, J's,
G's, K's, L's, I's, H's or A's bits differ between trees (the timings
are printed first).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "compare_trees"


def one(tree: Path, warmup: int, timed: int) -> dict:
    """Slice 5's frames and kernels E, J, B, D, F, G, K, L, I, H and A with
    the port of `tree`."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as cs  # the tree's own
    from plainrenderer_tpu_torch import native
    from plainrenderer_tpu_torch.ops import raster, sdfgi, shadow, taa
    from plainrenderer_tpu_torch.ops import texture
    from plainrenderer_tpu_torch.render import frame
    check_root = str(Path(cs.__file__).resolve().parent)
    if check_root != str(tree.resolve()):
        raise SystemExit(f"compare_trees: imported {check_root}, not {tree}")
    # this checkout's device timer, whichever tree runs
    spec = importlib.util.spec_from_file_location("timer_smoke",
                                                  ROOT / "chip_smoke.py")
    timer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = cs.Ctx(torch.device("cuda"))
    t0 = time.time()
    native.build()
    native.library()
    build_s = time.time() - t0
    ctx.luts = frame.bake_static_luts(cs.config.RenderSettings(),
                                      device=ctx.dev)
    exts = [cs.cam_mod.extrinsic_from_angles(  # bench.py:105-110's path
        [-9.0 + 0.02 * t, -1.8, 0.3 * np.sin(t * 0.05)], pitch_deg=8.0,
        yaw_deg=10.0 + t * 0.1) for t in range(warmup + timed)]
    ctx.cams = [frame.camera_arrays(e.position, e.forward, e.right, e.up,
                                    device=ctx.dev) for e in exts]
    ctx.cam_path = frame.camera_arrays(  # drive's camera path, one upload
        *(np.stack([getattr(e, k) for e in exts])
          for k in ("position", "forward", "right", "up")), device=ctx.dev)
    scene = cs.SCENES["bench"](ctx)
    frames = [scene] * len(ctx.cams)
    settings = cs.dataclasses.replace(
        cs.slice_settings(5, cs.WIDTH, cs.HEIGHT), pair_budget_scale=2.0)
    run = cs.drive(ctx, frames, settings, warmup, timed)
    cs.check(int(run["counters"].max()) == 0, "debug_counters [0, 0]")
    cs.check(run["host_syncs_per_frame"] == 0, "no host sync")

    rec = cs.record_frames(ctx, frames, settings, 2, [
        (frame, "render_shadow_atlas"), (frame, "raster_main_view"),
        (texture, "sample_materials"), (shadow, "shadow_resolve"),
        (frame, "trace_scene_gi"), (taa, "resample_history_taps"),
        (taa, "history_coords"), (taa, "resample_packed_planes"),
        (raster, "expand_keys")])
    atlas = frame.render_shadow_atlas(*rec["render_shadow_atlas"][0])
    mv = rec["raster_main_view"][0][0]
    main = frame.raster_main_view(mv)

    def e():
        return raster.rasterize_depth(atlas.edges, atlas.pairs,
                                      atlas.n_bins_y, atlas.n_bins_x,
                                      sub=atlas.sub, row_skip=True)

    # J merging the alpha casters into a clone of E's atlas: merging them
    # again (the timed calls) leaves it as it is
    a = atlas.alpha
    opaque = e()
    merged = opaque.clone()

    def j(into=merged):
        return raster.rasterize_depth(a.edges, a.pairs, a.n_bins_y,
                                      atlas.n_bins_x, sub=a.sub,
                                      alpha_masks=a.masks, init_depth=into)

    def b():
        return raster.rasterize_gbuffer(
            main.pair_edges, main.pair_attrs, main.pairs, mv.n_tiles_y,
            mv.n_tiles_x, sub=mv.sub, row_skip=True)

    targs, d_kw = rec["sample_materials"][0], cs.texture_kwargs(settings)
    sargs = rec["shadow_resolve"][0]
    f_args = (*sargs[:3], shadow.pack_shadow_maps_u16(sargs[3]).contiguous(),
              shadow.cascade_rows(*sargs[4:7]), sargs[7],
              settings.shadows.pcf_taps, settings.shadows.sample_radius)

    def d(**filters):
        return texture.sample_materials(*targs, **dict(d_kw, **filters))

    def f():
        return shadow.resolve_packed(*f_args)

    # G on the frame's trace inputs, as frame.trace_scene_gi calls it
    t_scene, inp, t_set, sun_dir, sun_col, sun_str = rec["trace_scene_gi"][0]
    st = t_set.sdf_trace
    g_args = (inp.world_pos, inp.normal, inp.ray_dirs, inp.valid,
              inp.sky_lowres, t_scene["sdf_volume"], t_scene["sdf_albedo"],
              t_scene["sdf_origin"], t_scene["sdf_voxel_size"],
              t_scene["sdf_grid"], sun_dir, sun_col, sun_str)
    g_kw = dict(steps=st.trace_steps, influence=st.influence_radius * 2.5,
                strict=st.strict_influence_radius_cutoff,
                dims_zyx=t_scene["sdf_grid"],
                coarse_fallback=st.coarse_fallback,
                coarse_tables=t_scene["sdf_coarse"])

    def g():
        y, c, esc = sdfgi.trace_gi(*g_args, **g_kw)
        return torch.cat([y, c, esc[None]])

    # G's host time, split: its arguments laid out, then the launch alone
    def g_setup():
        return sdfgi._trace_setup(
            *g_args, g_kw["steps"], g_kw["influence"], g_kw["strict"],
            g_kw["dims_zyx"], g_kw["coarse_fallback"], g_kw["coarse_tables"])

    sky, c_sdf, c_alb, meta, kw = g_setup()
    _, gh, gw = inp.world_pos.shape
    g_out = torch.empty((7, gh, gw), dtype=torch.float32, device=ctx.dev)

    def g_launch():
        native.launch("sdfgi_trace_launch", inp.world_pos, inp.normal,
                      inp.ray_dirs, inp.valid, sky, t_scene["sdf_volume"],
                      t_scene["sdf_albedo"], c_sdf, c_alb, meta, g_out, gh,
                      gw, *kw["dims"], *kw["coarse_dims"], kw["coarse_f"],
                      kw["steps"], int(kw["strict"]), int(kw["use_coarse"]),
                      kw["sky_h"], kw["sky_w"])

    pa = main.alpha_pairs

    def k():
        return raster.rasterize_winner_alpha(
            main.alpha_edges, pa, mv.alpha_masks, mv.n_tiles_y,
            mv.n_tiles_x, mv.sub, True)

    vis_k = k()[1]

    history, coords = rec["resample_history_taps"][1]
    motion, width, height, _ = rec["history_coords"][1]
    coords16 = taa.history_coords(motion, width, height, 1)[0]  # tech 1

    def i(c=coords):
        return taa.history_taps(history, c)

    planes_h, motion_h, width_h, height_h = rec["resample_packed_planes"][1]
    coords_h = taa.reprojected_coords(motion_h, width_h, height_h)

    def h():
        return taa.packed_planes(planes_h, coords_h)

    # A on frame 0's four streams (the first four calls: the second
    # frame's follow)
    cs.check(len(rec["expand_keys"]) == 8, "A runs 4 times a frame")
    key_inputs = [args[0] for args in rec["expand_keys"][:4]]

    def l():
        return raster.resolve_attributes(main.alpha_attrs, pa.tile_start,
                                         vis_k, mv.n_tiles_y, mv.n_tiles_x,
                                         mv.sub)

    def checksum(t):
        w = t.contiguous().view(torch.int32).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 1_000_003 + 1
        return int((w.flatten() * pos).sum())

    depth_b, vis_b, gbuf_b = b()
    counts = dict(
        atlas=timer.stream_counts(a.edges, a.pairs, atlas.n_bins_x, a.sub,
                                  row_skip=False, z=False),
        main=timer.stream_counts(main.alpha_edges, pa, mv.n_tiles_x, mv.sub,
                                 row_skip=True, z=True))
    sums = dict(atlas=checksum(opaque), alpha_atlas=checksum(
                    j(opaque.clone())), depth=checksum(depth_b),
                vis=checksum(vis_b), gbuf=checksum(gbuf_b),
                texture=checksum(d()), shadow=checksum(f()),
                gi=checksum(g()), alpha_depth=checksum(k()[0]),
                alpha_vis=checksum(vis_k), alpha_gbuf=checksum(l()),
                taps=checksum(i()), taps16=checksum(i(coords16)),
                planes=checksum(h()),
                keys=[checksum(torch.stack(raster.expand_keys(ki)))
                      for ki in key_inputs])
    streams = [dict(view="atlas" if ki.tpv < ki.cum.shape[0] else "main",
                    triangles=ki.cum.shape[0], budget=ki.budget,
                    live=int(ki.cum[-1]), **timer.cuda_ms(
                        lambda ki=ki: raster.expand_keys(ki), 50))
               for ki in key_inputs]
    passes = run["pass_ms"]
    return dict(
        tree=str(tree), build_s=build_s, sums=sums, alpha_counts=counts,
        frame_ms=passes["frame"], host_wall_ms=passes["host_wall_per_frame"],
        shadow_atlas_ms=passes["shadow_atlas"], gbuffer_ms=passes["gbuffer"],
        launches=run["launches"], e=timer.cuda_ms(e, 20),
        j=timer.cuda_ms(j, 20),
        b=timer.cuda_ms(b, 20), d=timer.cuda_ms(d, 20),
        d_tri_aniso=timer.cuda_ms(lambda: d(trilinear=True, aniso=True), 20),
        d_tri=timer.cuda_ms(lambda: d(trilinear=True, aniso=False), 20),
        f=timer.cuda_ms(f, 20),
        g=timer.cuda_ms(lambda: sdfgi.trace_gi(*g_args, **g_kw), 20),
        g_setup=timer.cuda_ms(g_setup, 20),
        g_launch=timer.cuda_ms(g_launch, 20),
        k=timer.cuda_ms(k, 20), l=timer.cuda_ms(l, 20),
        i=timer.cuda_ms(i, 20), h=timer.cuda_ms(h, 20), a=streams)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a checkout of the port")
    ap.add_argument("--order", help="comma-separated NAMEs, run in turn")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--timed", type=int, default=16)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(Path(args.one), args.warmup, args.timed)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    if not trees or any(n not in trees for n in order):
        raise SystemExit("compare_trees: --order names a tree not given")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    results = []
    for name in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one",
             str(Path(trees[name]).resolve()), "--warmup", str(args.warmup),
             "--timed", str(args.timed)], capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"compare_trees: {name} failed")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["name"] = name
        results.append(r)
        print(json.dumps({k: r[k] for k in (
            "name", "frame_ms", "host_wall_ms", "shadow_atlas_ms",
            "gbuffer_ms", "alpha_counts", "e", "j", "b", "d", "d_tri_aniso",
            "d_tri", "f", "g", "g_setup", "g_launch", "k", "l", "i", "h",
            "a", "build_s")}), flush=True)
    differ = {key: sorted({json.dumps(r["sums"][key]) for r in results})
              for key in ("atlas", "alpha_atlas", "gi", "alpha_depth",
                          "alpha_vis", "alpha_gbuf", "taps", "taps16",
                          "planes", "keys")}
    differ = {k: v for k, v in differ.items() if len(v) != 1}
    summary = {}
    for name in dict.fromkeys(order):
        rs = [r for r in results if r["name"] == name]
        summary[name] = {
            key: [f(r) for r in rs] for key, f in (
                ("frame_mean_ms", lambda r: r["frame_ms"]["mean"]),
                ("frame_min_ms", lambda r: r["frame_ms"]["min"]),
                ("host_wall_ms", lambda r: r["host_wall_ms"]["mean"]),
                ("shadow_atlas_ms", lambda r: r["shadow_atlas_ms"]["mean"]),
                ("e_ms", lambda r: r["e"]["ms"]),
                ("e_host_us", lambda r: r["e"]["host_us"]),
                ("j_ms", lambda r: r["j"]["ms"]),
                ("j_host_us", lambda r: r["j"]["host_us"]),
                ("b_ms", lambda r: r["b"]["ms"]),
                ("b_host_us", lambda r: r["b"]["host_us"]),
                ("d_ms", lambda r: r["d"]["ms"]),
                ("d_tri_aniso_ms", lambda r: r["d_tri_aniso"]["ms"]),
                ("d_tri_ms", lambda r: r["d_tri"]["ms"]),
                ("f_ms", lambda r: r["f"]["ms"]),
                ("g_ms", lambda r: r["g"]["ms"]),
                ("g_host_us", lambda r: r["g"]["host_us"]),
                ("g_setup_host_us", lambda r: r["g_setup"]["host_us"]),
                ("g_launch_ms", lambda r: r["g_launch"]["ms"]),
                ("g_launch_host_us", lambda r: r["g_launch"]["host_us"]),
                ("k_ms", lambda r: r["k"]["ms"]),
                ("k_host_us", lambda r: r["k"]["host_us"]),
                ("l_ms", lambda r: r["l"]["ms"]),
                ("l_host_us", lambda r: r["l"]["host_us"]),
                ("k_plus_l_ms", lambda r: r["k"]["ms"] + r["l"]["ms"]),
                ("i_ms", lambda r: r["i"]["ms"]),
                ("i_host_us", lambda r: r["i"]["host_us"]),
                ("h_ms", lambda r: r["h"]["ms"]),
                ("h_host_us", lambda r: r["h"]["host_us"]),
                *[(f"a{n}_ms", lambda r, n=n: r["a"][n]["ms"])
                  for n in range(4)],
                *[(f"a{n}_host_us", lambda r, n=n: r["a"][n]["host_us"])
                  for n in range(4)])}
        summary[name]["gbuffer_sums"] = sorted(
            {json.dumps(r["sums"], sort_keys=True) for r in rs})
        summary[name]["median"] = {
            k: statistics.median(v) for k, v in summary[name].items()}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "report.json").write_text(json.dumps(
        dict(card=smi, order=order, trees=trees, results=results,
             summary=summary, differ=differ), indent=1))
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    if differ:  # E, J, G, K, L, I, H and A equal their plain versions
        raise SystemExit(f"compare_trees: the trees' bits differ: {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
