"""plainrenderer_tpu_torch imports neither jax nor plainrenderer_tpu,
nor PIL, imageio or OpenCV (cv2), which the card's machine does not have
(the port reads and writes images with its own decoders).

Module names are matched exactly or by their dotted prefix: the port's
own name starts with "plainrenderer_tpu", so a substring test would be
wrong."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "plainrenderer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "plainrenderer_tpu", "PIL", "imageio",
             "cv2")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _module_names():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("plainrenderer_tpu.ops.raster")
    assert not _forbidden("plainrenderer_tpu_torch.ops.raster")
    assert not _forbidden("jaxtyping")
    assert _forbidden("PIL") and _forbidden("PIL.Image")
    assert _forbidden("imageio.v3") and not _forbidden("imageio_ffmpeg")


def test_torch_and_numpy_load_no_pil():
    """The runtime check below is only meaningful if torch and numpy do
    not bring PIL or imageio in themselves."""
    out = subprocess.run(
        [sys.executable, "-c", "import json, sys, numpy, torch\n"
         "print(json.dumps(sorted(sys.modules)))"], cwd=ROOT,
        capture_output=True, text=True, timeout=300, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if _forbidden(m)]


def test_importing_every_module_loads_no_jax():
    """Import every module of the port in a fresh interpreter and list
    what ended up in sys.modules."""
    modules = _module_names()
    assert len(modules) > 20
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad
    for m in ("render.frame", "ops.texture", "ops.shadow", "ops.hiz",
              "assets.textures", "assets.procedural", "render.scenebuild",
              "assets.sdf_bake", "ops.sdf_scene", "ops.sdfgi", "ops.taa",
              "parallel.halo", "utils.sh", "utils.sampling",
              "assets.compressed", "assets.plain_format", "assets.dds",
              "assets.image_io", "assets.gltf_import", "assets.pipeline",
              "assets.modes", "assets.bmp", "assets.tga", "assets.pnm",
              "assets.lzw", "assets.gif", "assets.tiff", "assets.webp",
              "assets.vp8l", "assets.vp8", "assets.jpeg",
              "assets.jpeg_encode", "assets.psd", "assets.qoi",
              "assets.sgi", "assets.pcx", "assets.ico", "assets.bcn",
              "assets.legacy", "assets.spider_fits", "assets.im",
              "assets.fli", "assets.blp", "assets.icns", "assets.pcd",
              "assets.iptc", "assets.webp_encode", "assets.webp_picture",
              "assets.vp8_encode", "assets.vp8l_encode", "assets.avif",
              "assets.avif_yuv", "assets.isobmff", "assets.av1_decode",
              "assets.av1_obu", "assets.av1_msac", "assets.av1_cdf",
              "assets.av1_block", "assets.av1_intra", "assets.av1_intrabc",
              "assets.av1_transform", "assets.av1_loopfilter",
              "assets.av1_cdef", "assets.av1_restoration",
              "assets.av1_filmgrain", "assets.avif_reformat",
              "assets.avif_scale", "assets.jp2", "assets.j2k_codestream",
              "assets.j2k_t2", "assets.j2k_recon", "assets.j2k_ht",
              "assets.avif_write", "assets.avif_rgb2yuv", "assets.av1_encode",
              "assets.av1_intra_search", "assets.av1_block_encode",
              "assets.av1_msac_encode", "assets.av1_obu_write",
              "assets.av1_fwd_transform", "assets.av1_quantize",
              "assets.av1_superres",
              "ops.debugviz", "runtime.shell", "runtime.overlay",
              "runtime.app", "parallel.comm", "parallel.sharding"):
        assert "plainrenderer_tpu_torch." + m in loaded, m


def test_sources_import_no_jax():
    """Every import statement in the port's sources, chip_smoke.py,
    compare_trees.py and the band tests' rank functions."""
    bad = []
    for path in sorted(PKG.rglob("*.py")) + [
            ROOT / "chip_smoke.py", ROOT / "compare_trees.py",
            ROOT / "tests" / "torch_band_ranks.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(str(path), n) for n in names if _forbidden(n)]
    assert not bad, bad


def test_band_ranks_load_no_jax():
    """comm.launch's spawned rank entry (comm._rank_main) imports the
    rank function's module afresh: 2 gloo CPU ranks list what they
    loaded."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import json, torch_band_ranks\n"
        "from plainrenderer_tpu_torch.parallel import comm\n"
        "if __name__ == '__main__':\n"
        "    out = comm.launch(torch_band_ranks.loaded_modules, 2,\n"
        "                      device='cpu', timeout=120.0)\n"
        "    print(json.dumps(out))\n")
    try:
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=180)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(
            f"the launcher ran past 180 s\n--- stdout ---\n{e.stdout}\n"
            f"--- stderr ---\n{e.stderr}") from e
    assert out.returncode == 0, (
        f"the launcher exited {out.returncode}\n--- stdout ---\n"
        f"{out.stdout}\n--- stderr ---\n{out.stderr}")
    ranks = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(ranks) == 2
    for loaded in ranks:
        assert "plainrenderer_tpu_torch.parallel.comm" in loaded
        assert not [m for m in loaded if _forbidden(m)]
