"""Rank functions for the band tests (comm.launch spawns them afresh).

This module imports torch and the port only, never JAX or the JAX
package: a spawned rank imports it by name, and its conftest-free import
keeps JAX out of the rank processes (each rank lists what it loaded)."""

import sys

import numpy as np
import torch

from plainrenderer_tpu_torch.ops import bloom, volumetrics
from plainrenderer_tpu_torch.parallel.halo import halo_extend


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package in this process."""
    bad = ("jax", "jaxlib", "plainrenderer_tpu")
    return sorted(m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in bad))


def loaded_modules(group) -> list:
    """Every module name this rank has loaded."""
    return sorted(sys.modules)


def band_rows(x: np.ndarray, rank: int, n: int) -> torch.Tensor:
    """Band `rank` of n of the row axis (-2) of a frame-sized array."""
    bh = x.shape[-2] // n
    return torch.as_tensor(np.ascontiguousarray(
        x[..., rank * bh:(rank + 1) * bh, :]))


def band_ops(group, cases: dict) -> dict:
    """Every rank's result of the banded ops on its band of each case's
    frame-sized inputs (numpy): halo_extend, compute_bloom_banded, the fog's
    coarse-to-fine upsample and its apply with one halo row."""
    r, n = group.rank, group.size
    out = {"forbidden": loaded_forbidden(), "transport": group.transport}
    out["halo"] = [halo_extend(band_rows(x, r, n).to(dtype), k, group)
                   for x, k, dtype in cases["halo"]]
    color, strength, radius, mips = cases["bloom"]
    out["bloom"] = bloom.compute_bloom_banded(
        band_rows(color, r, n), strength, radius, mips, group,
        lambda p, k: halo_extend(p, k, group))

    def halo_fn(p):
        return halo_extend(p, 1, group)
    coarse, fine_shape = cases["resize"]
    d, hf, wf = fine_shape
    out["resize"] = volumetrics._resize_coarse(
        band_rows(coarse, r, n), (d, hf // n, wf), halo_fn)
    hdr, depth, integrated, noise, max_dist = cases["fog"]
    out["fog"] = volumetrics.apply_froxel_fog(
        band_rows(hdr, r, n), band_rows(depth, r, n),
        band_rows(integrated, r, n), max_dist, band_rows(noise, r, n),
        halo_fn=halo_fn)
    out["stats"] = dict(group.stats)
    return out


def fail_on_rank_1(group):
    """Rank 1 raises; the others wait in a collective."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return group.sum_(torch.ones(1))


def hang_on_rank_1(group, seconds: float):
    """Rank 1 sleeps past the launcher's timeout; the others wait in a
    collective."""
    import time

    if group.rank == 1:
        time.sleep(seconds)
    return group.sum_(torch.ones(1))
