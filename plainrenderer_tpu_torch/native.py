"""Build, load and launch the port's hand-written CUDA kernels.

The sources under csrc/ expose a plain C interface (no PyTorch headers),
so each compiles with nvcc in seconds. At first use every source is
compiled to an object file for sm_90a, all nvcc processes started
together, and the objects are linked into one shared library under
_build/<hash of sources and flags>/. The library is loaded with ctypes:
every pointer and the stream are passed as c_void_p, every C entry point
returns cudaGetLastError() after its launch, and launch() raises when that
is not cudaSuccess.

launch() bumps a kernel's launch count, and the wrappers in ops/ call it
only on the branch that runs the kernel, so a count read after a run says
how many times the run went through that kernel. A launch recorded into a
CUDA graph capture (inside capturing()) runs nothing: it counts into the
capture's own dict, and count_replays() adds that dict once per replay of
the graph, the one other place that bumps the counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("expand_keys.cu", "gbuffer.cu", "material.cu", "texture.cu",
           "depth.cu", "shadow.cu", "sdfgi.cu", "packed_planes.cu",
           "history_taps.cu", "depth_alpha.cu", "gbuffer_alpha.cu",
           "expand_rows.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> (launch-count key, argtypes); every entry returns int
_ENTRIES = {
    # cum, cum_ex, geom, keys, owners, t_count, budget, n_tiles_x,
    # bin_rows, order_rows, order_alpha, tpv, sentinel, stream
    "expand_keys_launch": ("expand_keys", [_P] * 5 + [_I] * 8 + [_P]),
    # edges, attrs, rounded, tile_start, tile_count, aux, depth, vis, gbuf,
    # n_pairs, n_tiles_y, n_tiles_x, sub, row_skip, prev, stream
    "gbuffer_launch": ("gbuffer", [_P] * 9 + [_I] * 6 + [_P]),
    # table, ids, valid, out, n_pix, channels, stream
    "material_launch": ("material", [_P] * 4 + [_I] * 2 + [_P]),
    # edges, tile_start, tile_count, aux, depth, n_pairs, n_tiles_y,
    # n_tiles_x, sub, row_skip, stream
    "depth_launch": ("depth", [_P] * 5 + [_I] * 5 + [_P]),
    # world_pos, linear_depth, noise, maps, rows, spiral, spiral_host,
    # out, h, w, map_size, cascade_count, taps, sample_radius, inv_taps,
    # stream
    "shadow_launch": ("shadow", [_P] * 8 + [_I] * 5 + [_F, _F, _P]),
    # uv, duv, mat_id, valid, mat_tex, info, word0, word1, out, h, w,
    # n_mat, n_mips, two_mat, trilinear, aniso, mip_bias, stream
    "texture_launch": ("texture", [_P] * 9 + [_I] * 7 + [_F, _P]),
    # wpos, normal, dirs, valid, sky, sdf, alb, coarse_sdf, coarse_alb,
    # meta, out, h, w, vd, vh, vw, cd, ch, cw, coarse_f, steps, strict,
    # use_coarse, sky_h, sky_w, stream
    "sdfgi_trace_launch": ("sdfgi_trace", [_P] * 11 + [_I] * 14 + [_P]),
    # planes, coords, out, n_planes, h, w, stream
    "packed_planes_launch": ("packed_planes", [_P] * 3 + [_I] * 3 + [_P]),
    # history, coords, out, n_taps, h, w, stream
    "history_taps_launch": ("history_taps", [_P] * 3 + [_I] * 3 + [_P]),
    # edges, masks, tile_start, tile_count, aux, depth, n_pairs, n_masks,
    # n_tiles_y, n_tiles_x, sub, row_skip, stream
    "depth_alpha_launch": ("depth_alpha", [_P] * 6 + [_I] * 6 + [_P]),
    # edges, masks, tile_start, tile_count, aux, depth, vis, n_pairs,
    # n_masks, n_tiles_y, n_tiles_x, sub, row_skip, stream
    "winner_alpha_launch": ("winner_alpha", [_P] * 7 + [_I] * 6 + [_P]),
    # kernel L, its two grids from one call: attrs, table, tile_start, vis,
    # gbuf, n_pairs, n_tiles_y, n_tiles_x, sub, prev, stream
    "attr_resolve_launch": ("attr_resolve", [_P] * 5 + [_I] * 5 + [_P]),
    # owners, table, total, out, n_rows, n_cols, budget, stream
    "expand_rows_launch": ("expand_rows", [_P] * 4 + [_I] * 3 + [_P]),
}

_launches = {key: 0 for key, _ in _ENTRIES.values()}
_recording = None  # a capture's counts while capturing() is open
_lib = None
_lock = threading.Lock()


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset_launch_counts()."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for key in _launches:
        _launches[key] = 0


@contextlib.contextmanager
def capturing():
    """Count the launches of a CUDA graph capture apart: inside, launch()
    counts into the yielded dict (kernel name -> launches in one replay of
    the graph) and not into launch_counts(), since a capture runs
    nothing."""
    global _recording
    if _recording is not None:
        raise RuntimeError("capturing() does not nest")
    _recording = {key: 0 for key in _launches}
    try:
        yield _recording
    finally:
        _recording = None


def count_replays(step: dict, replays: int) -> None:
    """Count `replays` replays of a graph whose capture recorded `step`
    (capturing()'s dict): each replay launches those kernels again."""
    for key, n in step.items():
        _launches[key] += n * replays


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + ("common.cuh",):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into one shared library (cached by content hash);
    returns its path. Raises with nvcc's output when a compile fails."""
    out_dir = _build_dir()
    lib_path = out_dir / "libplain_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        # per-process names: concurrent first uses must not share files
        obj = out_dir / f"{Path(name).stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    for name, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
    tmp = out_dir / f"libplain_kernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *[str(o) for _, o, _ in procs],
         "-o", str(tmp)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (_, argtypes) in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.plain_kernels_error_string.argtypes = [ctypes.c_int]
            lib.plain_kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(entry: str, *args) -> None:
    """Call one C entry point with args (tensors pass their data_ptr(),
    ints pass as they are) on the current CUDA stream, raise on a launch
    error, and count the launch (into the open capture's dict inside
    capturing())."""
    import torch

    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    err = getattr(lib, entry)(*c_args, stream)
    if err != 0:
        msg = lib.plain_kernels_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")
    counts = _launches if _recording is None else _recording
    counts[_ENTRIES[entry][0]] += 1
