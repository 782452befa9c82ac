"""Camera conventions (plainrenderer_tpu/scene/camera.py).

World is y-down (default up = (0, -1, 0), Camera.h:4-9); view matrix rows
are (right, up, -forward) then translate by -position; the projection is
the Vulkan/reverse-Z corrected GL perspective: NDC y points down, depth
maps near -> 1 and far -> 0. Matrices are (4, 4) row-major f32 tensors
applied as M @ v. The extrinsic and intrinsic records stay numpy and
Python floats; the matrix helpers build tensors on `device` (the frame
builds its own matrices, render/frame.py _view_matrix / _projection).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32) if not
                           isinstance(v, torch.Tensor) else v,
                           dtype=torch.float32, device=device)


@dataclasses.dataclass
class CameraExtrinsic:
    """Camera.h:4-9."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, -1.0, -5.0], np.float32))
    forward: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -1.0], np.float32))
    right: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0], np.float32))
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], np.float32))


@dataclasses.dataclass
class CameraIntrinsic:
    """Camera.h:11-16. fov is vertical, degrees."""

    fov: float = 35.0
    aspect_ratio: float = 1.0
    near: float = 0.1
    far: float = 300.0


@dataclasses.dataclass
class Camera:
    extrinsic: CameraExtrinsic = dataclasses.field(
        default_factory=CameraExtrinsic)
    intrinsic: CameraIntrinsic = dataclasses.field(
        default_factory=CameraIntrinsic)


def view_matrix_from_extrinsic(position, forward, right, up,
                               device="cuda") -> torch.Tensor:
    """Camera.cpp:4-13 — rows (right, up, -forward), translated by
    -position."""
    dev = device_mod.resolve(device)
    rot = torch.stack([_f32(right, dev), _f32(up, dev),
                       -_f32(forward, dev)])
    m = torch.eye(4, dtype=torch.float32, device=dev)
    m[:3, :3] = rot
    m[:3, 3] = -rot @ _f32(position, dev)
    return m


def projection_matrix_from_intrinsic(fov_deg: float, aspect: float,
                                     near: float, far: float,
                                     device="cuda") -> torch.Tensor:
    """Camera.cpp:15-27 — GL perspective with the Vulkan / reverse-Z
    correction (near plane -> depth 1, far -> 0, NDC y down)."""
    dev = device_mod.resolve(device)
    tan_half = torch.tan(torch.deg2rad(_f32(fov_deg, dev)) * 0.5)
    p = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    p[0, 0] = 1.0 / (aspect * tan_half)
    p[1, 1] = 1.0 / tan_half
    p[2, 2] = -(far + near) / (far - near)
    p[2, 3] = -(2.0 * far * near) / (far - near)
    p[3, 2] = -1.0
    correction = _f32([[1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.0],
                       [0.0, 0.0, -0.5, 0.5], [0.0, 0.0, 0.0, 1.0]], dev)
    return correction @ p


def apply_projection_jitter(projection: torch.Tensor,
                            jitter_ndc) -> torch.Tensor:
    """TAA.cpp:172-179 — the per-frame jitter (NDC units) written into
    column 2 of rows 0 and 1; a new matrix."""
    out = projection.clone()
    jitter = _f32(jitter_ndc, out.device)
    out[0, 2] = jitter[0]
    out[1, 2] = jitter[1]
    return out


def view_projection(camera: Camera, jitter_ndc=None,
                    device="cuda") -> torch.Tensor:
    """RenderFrontend.cpp:423-454 — (jittered) projection @ view."""
    e, i = camera.extrinsic, camera.intrinsic
    view = view_matrix_from_extrinsic(e.position, e.forward, e.right, e.up,
                                      device=device)
    proj = projection_matrix_from_intrinsic(i.fov, i.aspect_ratio, i.near,
                                            i.far, device=device)
    if jitter_ndc is not None:
        proj = apply_projection_jitter(proj, jitter_ndc)
    return proj @ view


def look_at(eye, center, up, device="cuda") -> torch.Tensor:
    """glm::lookAt (right-handed), the shadow frustum fit's view
    (ViewFrustum.cpp:258)."""
    dev = device_mod.resolve(device)
    eye, center, up = (_f32(v, dev) for v in (eye, center, up))
    f = center - eye
    f = f / torch.linalg.vector_norm(f)
    s = torch.linalg.cross(f, up)
    s = s / torch.linalg.vector_norm(s)
    u = torch.linalg.cross(s, f)
    m = torch.eye(4, dtype=torch.float32, device=dev)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -torch.dot(s, eye)
    m[1, 3] = -torch.dot(u, eye)
    m[2, 3] = torch.dot(f, eye)
    return m


def extrinsic_from_angles(position, pitch_deg: float,
                          yaw_deg: float) -> CameraExtrinsic:
    """CameraController.cpp:9-56 — fly-camera forward/right/up from
    pitch/yaw in the y-down world."""
    pitch = np.deg2rad(pitch_deg)
    yaw = np.deg2rad(yaw_deg)
    forward = np.array(
        [np.cos(pitch) * np.cos(yaw), np.sin(pitch),
         np.cos(pitch) * np.sin(yaw)],
        np.float32,
    )
    forward /= np.linalg.norm(forward)
    world_up = np.array([0.0, -1.0, 0.0], np.float32)
    right = np.cross(world_up, forward)
    nrm = np.linalg.norm(right)
    if nrm < 1e-6:
        right = np.array([1.0, 0.0, 0.0], np.float32)
    else:
        right /= nrm
    up = np.cross(forward, right)
    up /= np.linalg.norm(up)
    return CameraExtrinsic(position=np.asarray(position, np.float32),
                           forward=forward, right=right, up=up)
