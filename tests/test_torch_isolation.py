"""plainrenderer_tpu_torch imports neither jax nor plainrenderer_tpu.

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
FORBIDDEN = ("jax", "jaxlib", "plainrenderer_tpu")


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
              "parallel.halo", "utils.sh", "utils.sampling"):
        assert "plainrenderer_tpu_torch." + m in loaded, m


def test_sources_import_no_jax():
    """Every import statement in the port's sources, chip_smoke.py and
    compare_trees.py."""
    bad = []
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                              ROOT / "compare_trees.py"]:
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
