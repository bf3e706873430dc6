"""Fly-camera controller — port of arctic_tpu/app/camera.py, host-side
parity with the reference's App::update / handle_event.

Reference semantics (app.cpp:109-171): WASD strafes along forward / right,
space / ctrl along world up, speed 10 u/s and mouse sensitivity 0.5 deg/px
(app.hpp:37-38); mouse-look adds xrel * sens to yaw and subtracts
yrel * sens from pitch; right = cross(forward, up), not renormalized, as in
the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from arctic_tpu_torch.core.scene import Camera


@dataclasses.dataclass
class FlyCamera:
    speed: float = 10.0  # app.hpp:37
    sensitivity: float = 0.5  # app.hpp:38

    def move(
        self,
        camera: Camera,
        dt: float,
        forward_input: float = 0.0,
        right_input: float = 0.0,
        up_input: float = 0.0,
    ) -> Camera:
        rot = camera.rotation.numpy().astype(np.float32)
        x, y = np.radians(rot[0]), np.radians(rot[1])
        fwd = np.array([np.cos(x) * np.cos(y), np.sin(x), np.cos(x) * np.sin(y)], np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(fwd, up)
        eye = camera.eye.numpy().astype(np.float32)
        eye = eye + self.speed * dt * (forward_input * fwd + up_input * up + right_input * right)
        return dataclasses.replace(camera, eye=torch.as_tensor(eye))

    def look(self, camera: Camera, dx_px: float, dy_px: float) -> Camera:
        rot = camera.rotation.numpy().astype(np.float32)
        rot = rot + np.array([-dy_px * self.sensitivity, dx_px * self.sensitivity], np.float32)
        return dataclasses.replace(camera, rotation=torch.as_tensor(rot))
