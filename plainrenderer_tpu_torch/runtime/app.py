"""The runtime application: scene load + frame loop
(plainrenderer_tpu/runtime/app.py).

Parity: Runtime/main.cpp:22-94 + App.cpp. The command line matches the
reference's `width height scenePath`; with no display the frame loop renders
an orbiting camera (or stdin commands, --interactive) and streams frames to
disk as PNGs, the analog of presenting to a swapchain. Embedders drive
`App.run_frame` with their own InputState per frame.

Usage:
  python -m plainrenderer_tpu_torch.runtime.app 1920 1080 scene.plain \\
      [--frames 120] [--out frames/] [--no-gi] [--cpu]
  (scenePath 'atrium' renders the built-in procedural scene.)

The app runs on the card; --cpu runs the plain PyTorch path on the CPU.
Without --cpu and without a usable GPU it raises. One difference from the
reference: the pair-budget escalation stops at MAX_PAIR_BUDGET_SCALE
(16x the default budget) with a warning, where app.py:183-207 doubles
without limit, also for per-bin cap drops that no budget cures.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import device as device_mod
from ..config import RenderSettings, SDFTraceSettings
from ..render import frame as frame_mod
from ..render import scenebuild
from ..render.state import FrameState, initial_state
from .shell import CameraController, FrameIndex, InputState, Timer

# the escalation's ceiling: 16x the default pair budgets
MAX_PAIR_BUDGET_SCALE = 16.0


class App:
    """App.cpp: owns the scene and camera; one render_frame per update."""

    def __init__(self, settings: RenderSettings, scene_path: str,
                 with_gi: bool = True, sdf_resolution_cap: int | None = None,
                 device="cuda"):
        self.device = device_mod.resolve(device)
        self.settings = settings
        # raise the pair budgets when a frame reports dropped pairs
        # (_maybe_escalate_budgets)
        self.auto_budget_escalation = True
        self.timer = Timer()
        self.frame_index = FrameIndex()
        self.camera = CameraController()
        # SDF volumes read from DDS files and baked at load
        self.sdf_loaded = self.sdf_baked = 0

        if scene_path == "atrium":
            from ..assets import procedural

            scene_data = procedural.build_atrium_scene()
        else:
            from ..assets.plain_format import load_binary_scene

            scene_data = load_binary_scene(scene_path)
        rs = scenebuild.build_render_scene(scene_data)
        print(f"scene: {rs.triangle_count} triangles, "
              f"{rs.object_count} objects", file=sys.stderr)
        self.scene = frame_mod.scene_to_device(rs, device=self.device)

        if with_gi and settings.sdf_trace.enabled:
            # baked DDS volumes named by the scene first; a missing file is
            # baked here (the reference hard-requires the DDS files,
            # App.cpp)
            gsdf = self._load_or_bake_sdf(scene_data, sdf_resolution_cap)
            self.scene = frame_mod.attach_global_sdf(self.scene, gsdf)

        self.luts = frame_mod.bake_static_luts(settings, device=self.device)
        self.state = initial_state(
            settings.width, settings.height,
            gi_half_res=settings.sdf_trace.half_resolution,
            device=self.device)

    def _load_or_bake_sdf(self, scene_data, resolution_cap):
        """Per object: its mesh's DDS volume when the file exists, else a
        bake on the app's device when the mesh names one, else nothing
        (noSDF); then the host composite (app.py:75-112)."""
        from ..assets import dds
        from ..ops import sdf_scene
        from ..render.scenebuild import _mesh_arrays

        volumes, bb_mins, bb_maxs, mats, albedos = [], [], [], [], []
        for obj in scene_data.objects:
            mesh = scene_data.meshes[obj.mesh_index]
            paths = getattr(mesh, "texture_paths", None)
            sdf_path = paths.sdf if paths else ""
            arrays = _mesh_arrays(mesh)
            bb_min = arrays["positions"].min(0)
            bb_max = arrays["positions"].max(0)
            vol = None
            if sdf_path and Path(sdf_path).exists():
                vol = dds.read_sdf_volume(sdf_path)
                self.sdf_loaded += 1
            elif sdf_path:
                from ..assets.sdf_bake import (bake_mesh_sdf,
                                               sdf_resolution_for_aabb)

                res = sdf_resolution_for_aabb(bb_min, bb_max)
                if resolution_cap:
                    res = tuple(min(r, resolution_cap) for r in res)
                vol = bake_mesh_sdf(arrays["positions"], arrays["indices"],
                                    bb_min, bb_max, resolution=res,
                                    device=self.device)
                self.sdf_baked += 1
            volumes.append(vol)
            bb_mins.append(bb_min)
            bb_maxs.append(bb_max)
            mats.append(np.asarray(obj.model_matrix, np.float32))
            albedos.append(np.asarray(mesh.mean_albedo, np.float32))
        if self.sdf_loaded:
            print(f"loaded {self.sdf_loaded} baked SDF volumes from DDS, "
                  f"baked {self.sdf_baked}", file=sys.stderr)
        return sdf_scene.composite_global_sdf(
            volumes, np.stack(bb_mins), np.stack(bb_maxs), np.stack(mats),
            np.stack(albedos))

    def set_settings(self, settings: RenderSettings):
        """Swap render settings at runtime (the ImGui panel analog). A
        change of resolution or of the GI resolution re-sizes the state
        buffers (app.py:114-130)."""
        old = self.settings
        if ((settings.width, settings.height,
             settings.sdf_trace.half_resolution)
                != (old.width, old.height, old.sdf_trace.half_resolution)):
            self.state = initial_state(
                settings.width, settings.height,
                gi_half_res=settings.sdf_trace.half_resolution,
                device=self.device)
        self.settings = settings

    def default_toggle_variants(self) -> list:
        """The settings variants a user plausibly toggles at runtime."""
        s = self.settings
        return [
            dataclasses.replace(s, sdf_trace=dataclasses.replace(
                s.sdf_trace, enabled=not s.sdf_trace.enabled)),
            dataclasses.replace(s, volumetrics=dataclasses.replace(
                s.volumetrics, enabled=not s.volumetrics.enabled)),
            dataclasses.replace(s, taa=dataclasses.replace(
                s.taa, enabled=not s.taa.enabled)),
            dataclasses.replace(s, draw_bounding_boxes=True),
        ]

    def precompile_variants(self, variants=None):
        """Warm alternate settings so that a runtime toggle does not stall
        on first use (app.py:147-163). The port compiles nothing ahead of
        time: what a toggle's first frame pays is the kernels' build and
        the frame's per-settings caches. So each variant renders one frame
        on a copy of the state (a fresh state where the variant re-sizes
        it), which is discarded: app.state stays as it was."""
        ext = self.camera.update(InputState(), 0.0)
        cam = self._camera(ext)
        for s in (variants or self.default_toggle_variants()):
            old = self.settings
            if ((s.width, s.height, s.sdf_trace.half_resolution)
                    == (old.width, old.height, old.sdf_trace.half_resolution)):
                state = FrameState(**{
                    f.name: getattr(self.state, f.name).clone()
                    for f in dataclasses.fields(FrameState)})
            else:
                state = initial_state(
                    s.width, s.height,
                    gi_half_res=s.sdf_trace.half_resolution,
                    device=self.device)
            frame_mod.render_frame(state, self.scene, cam, self.luts,
                                   1.0 / 60.0, s, device=self.device)
            print(f"warmed settings variant (hash {hash(s) & 0xffff})",
                  file=sys.stderr)

    def _camera(self, ext) -> dict:
        """The camera's four vectors on the app's device, one copy from
        pinned memory that does not wait for the device."""
        host = torch.from_numpy(np.stack([
            ext.position, ext.forward, ext.right, ext.up]).astype(np.float32))
        if self.device.type == "cuda":
            host = host.pin_memory()
        vecs = host.to(self.device, non_blocking=True)
        return dict(zip(("position", "forward", "right", "up"), vecs))

    def run_frame(self, inputs: InputState | None = None):
        """One main-loop iteration (main.cpp:79-90). Returns the (H, W, 3)
        u8 frame on the app's device."""
        self.timer.mark_new_frame()
        self.frame_index.mark_new_frame()
        ext = self.camera.update(inputs or InputState(),
                                 self.timer.delta_time)
        image, self.state = frame_mod.render_frame(
            self.state, self.scene, self._camera(ext), self.luts,
            self.timer.delta_time, self.settings, device=self.device)
        if self.auto_budget_escalation:
            self._maybe_escalate_budgets()
        return image

    def _maybe_escalate_budgets(self) -> bool:
        """A nonzero overflow counter means the frame dropped pairs
        (missing geometry or shadow casters): double pair_budget_scale,
        up to MAX_PAIR_BUDGET_SCALE, so that the next frame renders
        complete, and warn (app.py:183-207). The next frame sizes its pair
        buffers from the new scale. The check costs one device->host
        fetch; set auto_budget_escalation False to skip it. At the ceiling
        the drops come from per-bin caps or a scene no budget fits: it
        warns and stops."""
        ovf = self.state.debug_counters.cpu().numpy()
        if not ovf.any():
            return False
        old = self.settings.pair_budget_scale
        if old >= MAX_PAIR_BUDGET_SCALE:
            print(f"WARNING: raster pair overflow (main={int(ovf[0])}, "
                  f"shadow={int(ovf[1])}) at pair_budget_scale {old:g}, "
                  f"the ceiling {MAX_PAIR_BUDGET_SCALE:g}: not raised; "
                  "geometry or shadow casters are missing (a bin past its "
                  "pair cap drops pairs at any budget)", file=sys.stderr)
            return False
        new = min(old * 2.0, MAX_PAIR_BUDGET_SCALE)
        self.settings = dataclasses.replace(self.settings,
                                            pair_budget_scale=new)
        print(f"WARNING: raster pair overflow (main={int(ovf[0])}, "
              f"shadow={int(ovf[1])}): pair_budget_scale auto-raised "
              f"{old:g} -> {new:g}; this frame may be missing geometry, "
              "the next has the headroom", file=sys.stderr)
        return True


_last_overflow_warn = [0.0]


def _warn_overflow(state, where=sys.stderr) -> bool:
    """A nonzero debug counter means geometry or shadow casters were
    dropped this frame: print an actionable warning (at most once a
    second) (app.py:210-223)."""
    ovf = state.debug_counters.cpu().numpy()
    if ovf.any() and time.perf_counter() - _last_overflow_warn[0] > 1.0:
        _last_overflow_warn[0] = time.perf_counter()
        print(f"WARNING: raster pair overflow (main={int(ovf[0])}, "
              f"shadow={int(ovf[1])}): geometry/shadows may be missing; "
              "raise RenderSettings.pair_budget_scale", file=where)
        return True
    return bool(ovf.any())


def _memory_stats_mb(device) -> float:
    """MB of live tensors on the card (the allocator-stats analog of the
    reference's memory panel, RenderFrontend.cpp:1990-2011); 0 on the
    CPU, which has no allocator statistics."""
    if torch.device(device).type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(device) / 1e6


def interactive_loop(app: App, out_dir: Path, overlay: bool,
                     overlay_scale: int, max_frames: int = 0,
                     command_stream=None):
    """Drive the app from stdin, the InputManager / ImGui-panel analog
    (app.py:238-344). A reader thread turns lines into input and settings
    events consumed by the frame loop; frames stream to <out>/latest.png
    atomically. Commands:
      w/a/s/d [m]   move (forward/left/back/right, default 1 m)
      look DX DY    mouse-look degrees
      gi|taa|vol|aabb|cascades   toggle settings
      q             quit

    command_stream: any line iterable (tests pass a scripted list);
    defaults to sys.stdin."""
    import queue
    import threading

    from ..assets.image_io import save_image
    from .overlay import burn_stats

    cmds: "queue.Queue[str]" = queue.Queue()
    source = command_stream if command_stream is not None else sys.stdin

    def reader():
        for line in source:
            cmds.put(line.strip())

    reader_thread = threading.Thread(target=reader, daemon=True)
    reader_thread.start()
    if command_stream is not None:
        # a scripted stream ends at once; joining lets the first frame see
        # every command
        reader_thread.join(timeout=60)
    print("interactive: w/a/s/d [m], look DX DY, gi/taa/vol/aabb/cascades, q",
          file=sys.stderr)

    running = True
    frame_no = 0
    while running and (max_frames <= 0 or frame_no < max_frames):
        inputs = InputState(right_mouse_down=True)
        move = np.zeros(3, np.float32)
        while True:
            try:
                line = cmds.get_nowait()
            except queue.Empty:
                break
            parts = line.split()
            if not parts:
                continue
            op = parts[0].lower()
            arg = float(parts[1]) if len(parts) > 1 else 1.0
            s = app.settings
            if op == "q":
                running = False
            elif op in ("w", "a", "s", "d"):
                fwd = app.camera.forward_vector()
                right = app.camera.right_vector()
                move += {"w": fwd, "s": -fwd, "d": right,
                         "a": -right}[op] * arg
            elif op == "look" and len(parts) >= 3:
                inputs.mouse_movement = (float(parts[1]), float(parts[2]))
            elif op == "gi":
                app.set_settings(dataclasses.replace(
                    s, sdf_trace=dataclasses.replace(
                        s.sdf_trace, enabled=not s.sdf_trace.enabled)))
            elif op == "taa":
                app.set_settings(dataclasses.replace(
                    s, taa=dataclasses.replace(
                        s.taa, enabled=not s.taa.enabled)))
            elif op == "vol":
                app.set_settings(dataclasses.replace(
                    s, volumetrics=dataclasses.replace(
                        s.volumetrics, enabled=not s.volumetrics.enabled)))
            elif op == "aabb":
                app.set_settings(dataclasses.replace(
                    s, draw_bounding_boxes=not s.draw_bounding_boxes))
            elif op == "cascades":
                app.set_settings(dataclasses.replace(
                    s, shadows=dataclasses.replace(
                        s.shadows, debug_cascade_colors=not
                        s.shadows.debug_cascade_colors)))
        app.camera.position = app.camera.position + move
        t0 = time.perf_counter()
        frame = app.run_frame(inputs).cpu().numpy()
        frame_ms = (time.perf_counter() - t0) * 1e3
        stats = [f"{1e3 / max(frame_ms, 1e-3):6.1f} FPS  {frame_ms:7.2f} MS",
                 f"GI:{'ON' if app.settings.sdf_trace.enabled else 'OFF'}"
                 f" TAA:{'ON' if app.settings.taa.enabled else 'OFF'}"
                 f" VOL:{'ON' if app.settings.volumetrics.enabled else 'OFF'}"]
        if _warn_overflow(app.state):
            ovf = app.state.debug_counters.cpu().numpy()
            stats.append(f"OVERFLOW MAIN {int(ovf[0])} SHADOW {int(ovf[1])}")
        if overlay:
            frame = burn_stats(frame, stats, scale=overlay_scale)
        tmp = out_dir / ".latest.tmp.png"
        save_image(tmp, frame)
        tmp.replace(out_dir / "latest.png")  # atomic present
        print(" | ".join(stats), file=sys.stderr)
        frame_no += 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("width", type=int, nargs="?", default=1280)
    ap.add_argument("height", type=int, nargs="?", default=720)
    ap.add_argument("scene", nargs="?", default="atrium")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default="frames")
    ap.add_argument("--no-gi", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--orbit-speed", type=float, default=20.0)
    ap.add_argument("--live", action="store_true",
                    help="also write <out>/latest.png atomically each frame "
                         "(poll it with any image viewer for a live view, "
                         "the swapchain-present analog)")
    ap.add_argument("--no-overlay", action="store_true",
                    help="disable the on-image stats burn-in")
    ap.add_argument("--overlay-scale", type=int, default=2)
    ap.add_argument("--precompile-toggles", action="store_true",
                    help="warm the common settings toggles up front so that "
                         "runtime changes do not stall on first use")
    ap.add_argument("--cam", type=float, nargs=3,
                    default=[-9.0, -1.8, 0.0],
                    help="camera position x y z (y-down world)")
    ap.add_argument("--yaw", type=float, default=10.0)
    ap.add_argument("--pitch", type=float, default=8.0)
    ap.add_argument("--interactive", action="store_true",
                    help="drive the camera + settings from stdin commands "
                         "(w/a/s/d, look DX DY, gi/taa/vol/aabb/cascades, "
                         "q) while streaming <out>/latest.png")
    args = ap.parse_args(argv)

    settings = RenderSettings(
        width=args.width, height=args.height,
        sdf_trace=SDFTraceSettings(enabled=not args.no_gi))
    app = App(settings, args.scene, with_gi=not args.no_gi,
              sdf_resolution_cap=32, device="cpu" if args.cpu else "cuda")
    app.camera.position = np.asarray(args.cam, np.float32)
    app.camera.yaw = args.yaw
    app.camera.pitch = args.pitch

    if args.precompile_toggles:
        app.precompile_variants()

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.interactive:
        interactive_loop(app, out_dir, not args.no_overlay,
                         args.overlay_scale, max_frames=args.frames)
        return
    from ..assets.image_io import save_image
    from .overlay import burn_stats

    inputs = InputState(right_mouse_down=True)
    last_print = 0.0
    fps_smooth = None
    for i in range(args.frames):
        inputs.mouse_movement = (args.orbit_speed * app.timer.delta_time, 0.0)
        t0 = time.perf_counter()
        frame = app.run_frame(inputs).cpu().numpy()  # waits for the frame
        frame_ms = (time.perf_counter() - t0) * 1e3
        fps = 1e3 / max(frame_ms, 1e-3)
        fps_smooth = fps if fps_smooth is None else \
            fps_smooth + (fps - fps_smooth) * 0.2
        stats = [
            f"{fps_smooth:6.1f} FPS  {frame_ms:7.2f} MS",
            f"{app.settings.width}X{app.settings.height}"
            f"  GI:{'ON' if app.settings.sdf_trace.enabled else 'OFF'}",
            f"MEM {_memory_stats_mb(app.device):7.1f} MB  EXP"
            f" {float(app.state.exposure):.5f}",
        ]
        if _warn_overflow(app.state):  # dropped pairs = missing geometry
            ovf = app.state.debug_counters.cpu().numpy()
            stats.append(f"OVERFLOW MAIN {int(ovf[0])} SHADOW {int(ovf[1])}")
        if not args.no_overlay:
            frame = burn_stats(frame, stats, scale=args.overlay_scale)
        save_image(out_dir / f"frame_{i:04d}.png", frame)
        if args.live:
            tmp = out_dir / ".latest.tmp.png"
            save_image(tmp, frame)
            tmp.replace(out_dir / "latest.png")  # atomic present
        now = time.perf_counter()
        if now - last_print > 0.2:  # the reference's 0.2 s stats cadence
            print(" | ".join(stats), file=sys.stderr)
            last_print = now
    print(f"wrote {args.frames} frames to {out_dir}", file=sys.stderr)


if __name__ == "__main__":
    main()
