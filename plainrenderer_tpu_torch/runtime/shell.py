"""Timer, frame index, input state and fly-camera controller (a copy of
plainrenderer_tpu/runtime/shell.py: host-side numpy, the same numbers for
the same inputs, tests/test_torch_runtime.py).

Parity:
  - Timer (Runtime/Timer.cpp:18-27): delta time with the 0.3 s pause clamp;
  - FrameIndex (Runtime/FrameIndex.cpp:12-19): global counter + mod 2/3/4/8
    (the device-side frame uses FrameState.frame_index; this host mirror
    drives host-side decisions like noise-texture rotation in tools);
  - InputManager (Runtime/InputManager.cpp): a headless key/mouse state
    container that embedders (or a terminal/remote UI) feed;
  - CameraController (Runtime/CameraController.cpp:9-56): WASD + mouse-look
    fly camera with sprint, yaw/pitch limits, the y-down world convention.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..scene.camera import CameraExtrinsic


class Timer:
    """Runtime/Timer.cpp."""

    def __init__(self):
        self._last = time.perf_counter()
        self.delta_time = 1.0 / 60.0
        self.time = 0.0

    def mark_new_frame(self):
        now = time.perf_counter()
        self.delta_time = now - self._last
        if self.delta_time > 0.3:  # paused-application workaround
            self.delta_time = 0.016
        self._last = now
        self.time += self.delta_time


class FrameIndex:
    """Runtime/FrameIndex.cpp."""

    def __init__(self):
        self.index = 0

    def mark_new_frame(self):
        self.index += 1

    @property
    def mod2(self):
        return self.index % 2

    @property
    def mod3(self):
        return self.index % 3

    @property
    def mod4(self):
        return self.index % 4

    @property
    def mod8(self):
        return self.index % 8


@dataclasses.dataclass
class InputState:
    """Headless InputManager: embedders set fields per frame."""

    keys_down: set = dataclasses.field(default_factory=set)
    mouse_movement: tuple = (0.0, 0.0)
    right_mouse_down: bool = False

    def is_key_down(self, key: str) -> bool:
        return key in self.keys_down


class CameraController:
    """Runtime/CameraController.cpp:9-56: identical control math."""

    def __init__(self, position=(0.0, -1.0, -5.0), yaw=90.0, pitch=0.0,
                 movement_speed=3.0, sprint_factor=4.0,
                 mouse_sensitivity=0.2):
        self.position = np.asarray(position, np.float32).copy()
        self.yaw = yaw
        self.pitch = pitch
        self.movement_speed = movement_speed
        self.sprint_factor = sprint_factor
        self.mouse_sensitivity = mouse_sensitivity

    def forward_vector(self) -> np.ndarray:
        """Current forward direction (y-down world), without input."""
        yaw_r = np.deg2rad(self.yaw)
        pitch_r = np.deg2rad(self.pitch)
        return np.asarray([
            np.cos(pitch_r) * np.cos(yaw_r),
            -np.sin(pitch_r),
            np.cos(pitch_r) * np.sin(yaw_r),
        ], np.float32)

    def right_vector(self) -> np.ndarray:
        up = np.asarray([0.0, -1.0, 0.0], np.float32)
        right = np.cross(up, self.forward_vector())
        return right / max(np.linalg.norm(right), 1e-9)

    def update(self, inputs: InputState, delta_time: float) -> CameraExtrinsic:
        if inputs.right_mouse_down:
            self.yaw += self.mouse_sensitivity * inputs.mouse_movement[0]
            self.pitch -= self.mouse_sensitivity * inputs.mouse_movement[1]
        self.pitch = float(np.clip(self.pitch, -85.0, 85.0))

        yaw_r = np.deg2rad(self.yaw)
        pitch_r = np.deg2rad(self.pitch)
        forward = np.asarray([
            np.cos(pitch_r) * np.cos(yaw_r),
            -np.sin(pitch_r),
            np.cos(pitch_r) * np.sin(yaw_r),
        ], np.float32)
        up = np.asarray([0.0, -1.0, 0.0], np.float32)
        right = np.cross(up, forward)
        right /= max(np.linalg.norm(right), 1e-9)
        up = np.cross(forward, right)

        speed = self.movement_speed * delta_time
        if inputs.is_key_down("shift"):
            speed *= self.sprint_factor
        if inputs.is_key_down("w"):
            self.position += forward * speed
        if inputs.is_key_down("s"):
            self.position -= forward * speed
        if inputs.is_key_down("d"):
            self.position += right * speed
        if inputs.is_key_down("a"):
            self.position -= right * speed

        return CameraExtrinsic(
            position=self.position.copy(), forward=forward, right=right,
            up=up)
