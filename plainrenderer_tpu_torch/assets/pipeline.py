"""Asset pipeline: glTF -> .plain + per-mesh SDF DDS volumes
(plainrenderer_tpu/assets/pipeline.py).

Parity: AssetPipeline/mainPipeline.cpp:29-71:
  1. loadModelGLTF         (gltf_import.load_model_gltf)
  2. meshesToBinary        (plain_format.scene_to_binary)
  3. saveBinaryScene       (plain_format.save_binary_scene)
  4. computeSceneSDFTextures + writeDDSFile per mesh (sdf_bake + dds).

The SDF bake runs on the card (assets/sdf_bake.bake_mesh_sdf, the exact
dense bake), mesh after mesh; the JAX package's process pool and C++
baker have no counterpart here. --cpu bakes on the CPU.

Usage: python -m plainrenderer_tpu_torch.assets.pipeline model.gltf [out.plain]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def run_pipeline(gltf_path: str, out_path: str | None = None,
                 device="cuda") -> str:
    """Import gltf_path, write its .plain (next to it unless out_path)
    and bake each mesh's SDF into the DDS file its texture paths name
    (skipped for noSDF meshes, mainPipeline.cpp:60-69). Returns the
    .plain path."""
    from . import dds
    from .gltf_import import load_model_gltf
    from .plain_format import save_binary_scene, scene_to_binary
    from .sdf_bake import bake_mesh_sdf

    gltf_path = Path(gltf_path)
    if out_path is None:
        out_path = gltf_path.with_suffix(".plain")

    t0 = time.time()
    scene = load_model_gltf(gltf_path)
    print(f"loaded {len(scene.meshes)} meshes, {len(scene.objects)} objects "
          f"({time.time() - t0:.1f}s)", file=sys.stderr)
    save_binary_scene(out_path, scene_to_binary(scene))
    print(f"wrote {out_path}", file=sys.stderr)

    t0 = time.time()
    for i, mesh in enumerate(scene.meshes):
        if not mesh.texture_paths.sdf:
            continue
        volume = bake_mesh_sdf(mesh.positions, mesh.indices, device=device)
        Path(mesh.texture_paths.sdf).parent.mkdir(parents=True,
                                                  exist_ok=True)
        dds.write_sdf_volume(mesh.texture_paths.sdf, volume)
        print(f"  sdf {i}: {volume.shape}", file=sys.stderr)
    print(f"SDF computation time: {time.time() - t0:.1f}s", file=sys.stderr)
    return str(out_path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("gltf")
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="bake the SDFs on the CPU")
    args = ap.parse_args(argv)
    run_pipeline(args.gltf, args.out, device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
