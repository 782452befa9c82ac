"""Miscellaneous math helpers (plainrenderer_tpu/utils/mathutils.py)."""

from __future__ import annotations

import torch


def direction_to_vector(direction_deg: torch.Tensor) -> torch.Tensor:
    """MathUtils.cpp:4-16 — (phi, theta) degrees -> unit vector, y up is
    -cos(theta) (the reference's sun direction convention)."""
    theta = torch.deg2rad(direction_deg[..., 1])
    phi = torch.deg2rad(direction_deg[..., 0])
    return torch.stack([
        torch.sin(theta) * torch.cos(phi),
        -torch.cos(theta),
        torch.sin(theta) * torch.sin(phi),
    ], dim=-1)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once, as XLA:CPU's contracted multiply-adds
    round it: the product of two f32 values is exact in f64, and the f64
    sum rounds to f32 like the fused operation except in ties that are
    ~2^-29 rare. The same on the CPU and the card (no hardware FMA or
    contraction is relied on)."""
    return (a.double() * b.double() + c.double()).float()


def fma_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) rounded as XLA:CPU's dot rounds it:
    the first product, then one fused multiply-add per k (the frame's 4x4
    camera products and the object transforms' batched ones, so that they
    are the same on every device)."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        acc = fma(a[..., :, k:k + 1], b[..., k:k + 1, :], acc)
    return acc


def lu_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of small f32 matrices (..., n, n) by LU with partial
    pivoting (first largest pivot), multipliers scaled by the pivot's
    reciprocal, then a unit-lower and an upper triangular solve against the
    permuted identity: the order of LAPACK's getrf + trsm, which the JAX
    package's jnp.linalg.inv calls on the CPU, matrix by matrix. Only
    tensor ops, so no host synchronisation, and the same bits on every
    device; the frame's static-camera motion vectors are this inverse's
    rounding noise (see ops/shade.reconstruct_world_position)."""
    n = a.shape[-1]
    lu = a.clone()
    rows = torch.arange(n, device=a.device)
    perm = rows.expand(a.shape[:-1]).clone()
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for j in range(n - 1):
        p = (j + torch.argmax(torch.abs(lu[..., j:, j]), dim=-1))[..., None]
        swap = torch.where(rows == j, p, torch.where(rows == p, j, rows))
        lu = torch.gather(lu, -2, swap[..., None].expand(lu.shape))
        perm = torch.gather(perm, -1, swap)
        lu[..., j + 1:, j] = lu[..., j + 1:, j] * (one / lu[..., j, j])[
            ..., None]
        lu[..., j + 1:, j + 1:] = lu[..., j + 1:, j + 1:] \
            - lu[..., j + 1:, j, None] * lu[..., j, None, j + 1:]
    x = (perm[..., :, None] == rows).to(a.dtype)  # P @ I
    out = [x[..., i, :] for i in range(n)]
    for i in range(n):  # L y = P, unit lower
        for k in range(i):
            out[i] = fma(-lu[..., i, k, None], out[k], out[i])
    for k in range(n - 1, -1, -1):  # U x = y
        out[k] = out[k] * (one / lu[..., k, k])[..., None]
        for i in range(k):
            out[i] = fma(-lu[..., i, k, None], out[k], out[i])
    return torch.stack(out, dim=-2)

