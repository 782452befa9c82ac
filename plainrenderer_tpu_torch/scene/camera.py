"""Camera conventions (plainrenderer_tpu/scene/camera.py).

World is y-down (default up = (0, -1, 0), Camera.h:4-9); view matrix rows
are (right, up, -forward) then translate by -position; the projection is
the Vulkan/reverse-Z corrected GL perspective (render/frame.py
_projection). Host-side helpers stay numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
