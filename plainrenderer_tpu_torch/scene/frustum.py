"""View frustums and AABB-vs-frustum culling
(plainrenderer_tpu/scene/frustum.py; ViewFrustum.cpp, Culling.cpp:5-41).

The frame culls in clip space against its view-projection
(visible_objects_clipspace), which needs no frustum planes and no host
round trip. The frustum records (8 corner points, a point and an outward
normal per plane) and the 8-corner halfspace test are the reference's
host-side path. Point order (getFrustumPoints, ViewFrustum.cpp:231-242):
0 l_l_f, 1 l_l_n, 2 r_l_f, 3 r_l_n, 4 l_u_f, 5 l_u_n, 6 r_u_f, 7 r_u_n.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import device as device_mod
from .aabb import aabb_corners
from .camera import Camera, look_at

L_L_F, L_L_N, R_L_F, R_L_N, L_U_F, L_U_N, R_U_F, R_U_N = range(8)


@dataclasses.dataclass
class ViewFrustum:
    points: torch.Tensor  # (8, 3)
    plane_points: torch.Tensor  # (6, 3) a point on each plane
    plane_normals: torch.Tensor  # (6, 3) outward normals


def _normalize(v):
    return v / torch.clamp_min(
        torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-20)


def _frustum_from_points(p: torch.Tensor) -> ViewFrustum:
    """ViewFrustum.cpp:39-52's outward normals and Culling.cpp:17-24's
    plane points, in the order top, bottom, near, far, left, right."""
    def n(a, b):
        return _normalize(torch.linalg.cross(a, b))
    normals = torch.stack([
        n(p[R_U_F] - p[R_U_N], p[R_U_N] - p[L_U_N]),
        n(p[R_L_N] - p[L_L_N], p[R_L_F] - p[R_L_N]),
        n(p[R_U_N] - p[R_L_N], p[R_L_N] - p[L_L_N]),
        n(p[R_L_F] - p[L_L_F], p[R_U_F] - p[R_L_F]),
        n(p[L_L_F] - p[L_L_N], p[L_U_N] - p[L_L_N]),
        n(p[R_U_N] - p[R_L_N], p[R_L_F] - p[R_L_N])])
    points = torch.stack([p[L_U_F], p[L_L_F], p[L_U_N], p[L_U_F], p[L_U_F],
                          p[R_U_F]])
    return ViewFrustum(points=p, plane_points=points, plane_normals=normals)


def compute_view_frustum(camera: Camera, device="cuda") -> ViewFrustum:
    """ViewFrustum.cpp:4-37: the camera's 8 frustum corners."""
    dev = device_mod.resolve(device)
    e, i = camera.extrinsic, camera.intrinsic

    def t(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)
    pos, fwd, up, right = (t(v) for v in (e.position, e.forward, e.up,
                                          e.right))
    near_c = pos + fwd * i.near
    far_c = pos + fwd * i.far
    tan_fov = torch.tan(torch.deg2rad(t(i.fov)) * 0.5)
    h_near, h_far = tan_fov * i.near, tan_fov * i.far
    w_near, w_far = h_near * i.aspect_ratio, h_far * i.aspect_ratio
    pts = [None] * 8
    pts[R_U_F] = far_c + up * h_far + right * w_far
    pts[L_U_F] = far_c + up * h_far - right * w_far
    pts[R_L_F] = far_c - up * h_far + right * w_far
    pts[L_L_F] = far_c - up * h_far - right * w_far
    pts[R_U_N] = near_c + up * h_near + right * w_near
    pts[L_U_N] = near_c + up * h_near - right * w_near
    pts[R_L_N] = near_c - up * h_near + right * w_near
    pts[L_L_N] = near_c - up * h_near - right * w_near
    return _frustum_from_points(torch.stack(pts))


def compute_ortho_frustum_fitted_to_camera(camera_frustum: ViewFrustum,
                                           light_direction) -> ViewFrustum:
    """ViewFrustum.cpp:244-283 — the light-space box around the camera
    frustum, as a frustum (the whole-scene sun frustum; the cascades are
    fitted on the device, ops/shadow.py)."""
    pts = camera_frustum.points
    dev = pts.device
    light = torch.as_tensor(light_direction, dtype=torch.float32,
                            device=dev)
    up = torch.where(torch.abs(light[1]) < 0.999,
                     torch.tensor([0.0, -1.0, 0.0], device=dev),
                     torch.tensor([0.0, 0.0, -1.0], device=dev))
    v = look_at(-light, torch.zeros(3, device=dev), up, device=dev)
    ones = torch.ones((8, 1), dtype=torch.float32, device=dev)
    transformed = (v @ torch.cat([pts, ones], dim=1).T).T[:, :3]
    min_p, max_p = transformed.amin(dim=0), transformed.amax(dim=0)
    scale = 2.0 / (max_p - min_p)
    offset = -0.5 * (max_p + min_p) * scale
    clip = torch.eye(4, dtype=torch.float32, device=dev)
    clip[0, 0], clip[1, 1], clip[2, 2] = scale[0], scale[1], scale[2]
    clip[:3, 3] = offset
    clip_to_world = torch.linalg.inv(clip @ v)
    corners = torch.tensor(
        [[-1, -1, -1], [1, -1, -1], [-1, 1, -1], [1, 1, -1],
         [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1]],
        dtype=torch.float32, device=dev)
    world = (clip_to_world @ torch.cat([corners, ones], dim=1).T).T
    world = world[:, :3] / world[:, 3:4]
    out = [None] * 8  # ViewFrustum.cpp:272-279: l_l_n, r_l_n, l_u_n, ...
    (out[L_L_N], out[R_L_N], out[L_U_N], out[R_U_N], out[L_L_F],
     out[R_L_F], out[L_U_F], out[R_U_F]) = world
    return _frustum_from_points(torch.stack(out))


def visible_objects_clipspace(view_proj: torch.Tensor, bb_min: torch.Tensor,
                              bb_max: torch.Tensor,
                              cull_z: bool = True) -> torch.Tensor:
    """Conservative per-object culling: an AABB is culled iff all 8 corners
    are outside the same clip half-space (|x| > w, |y| > w, z < 0 or
    z > w, reverse-Z Vulkan conventions). bb_min/bb_max (N, 3) -> (N,) bool.
    cull_z=False drops the z test: shadow cascades render with depth
    clamping, so casters outside the fitted z range still matter.
    """
    corners = aabb_corners(bb_min, bb_max)  # (N, 8, 3)
    flat = corners.reshape(-1, 3)
    clip = flat @ view_proj[:3, :3].T + view_proj[:3, 3]
    w = flat @ view_proj[3, :3] + view_proj[3, 3]
    clip = clip.reshape(corners.shape[0], 8, 3)
    w = w.reshape(corners.shape[0], 8)
    out_l = torch.all(clip[..., 0] < -w, dim=1)
    out_r = torch.all(clip[..., 0] > w, dim=1)
    out_t = torch.all(clip[..., 1] < -w, dim=1)
    out_b = torch.all(clip[..., 1] > w, dim=1)
    outside = out_l | out_r | out_t | out_b
    if cull_z:
        out_n = torch.all(clip[..., 2] < 0.0, dim=1)
        out_f = torch.all(clip[..., 2] > w, dim=1)
        outside = outside | out_n | out_f
    return ~outside


def expand_object_mask(obj_mask: torch.Tensor, tri_starts: torch.Tensor,
                       t_count: int) -> torch.Tensor:
    """Per-object mask (O,) bool -> per-triangle mask (T,) bool.

    Triangles are object-contiguous, so the mask is a scatter of per-object
    deltas at each object's first triangle plus one int32 prefix sum
    (torch.cumsum widens to int64 unless told otherwise)."""
    vals = obj_mask.to(torch.int32)
    deltas = torch.diff(vals, prepend=vals.new_zeros(1))
    # JAX's mode="drop": out-of-range starts add nothing (masked, not
    # filtered, so no device-to-host sync)
    keep = tri_starts < t_count
    acc = torch.zeros((t_count,), dtype=torch.int32, device=obj_mask.device)
    acc.index_add_(0, tri_starts.clamp(max=t_count - 1).long(),
                   torch.where(keep, deltas, 0))
    return torch.cumsum(acc, 0, dtype=torch.int32) > 0


def aabb_intersects_frustum(frustum: ViewFrustum, bb_min: torch.Tensor,
                            bb_max: torch.Tensor) -> torch.Tensor:
    """Culling.cpp:5-41 over (N, 3) boxes -> (N,) bool: a box is culled iff
    all 8 corners lie strictly outside one plane (dot(corner - plane
    point, normal) > 0), the reference's conservative test."""
    corners = aabb_corners(bb_min, bb_max)  # (N, 8, 3)
    diff = corners[:, None, :, :] - frustum.plane_points[None, :, None, :]
    signs = torch.sign(torch.einsum("npkj,pj->npk", diff,
                                    frustum.plane_normals))
    return ~torch.any(torch.all(signs > 0, dim=2), dim=1)
