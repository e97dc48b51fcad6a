"""Camera with quaternion orientation and reverse-z Vulkan-style projection.

Port of src/scene/camera.{h,cpp}: view matrix from quaternion + position
(camera.cpp:10-23), perspective with swapped near/far and hand-built inverse
(camera.cpp:61-131), FPS-style movement helpers (camera.cpp:185-238).

All matrices are row-major numpy float64 on the host, applied as M @ v; the
render path downcasts to float32 when filling launch params.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from refport.utils import math3d as m3


@dataclass
class CameraMatrices:
    perspective: np.ndarray = field(default_factory=m3.identity4)
    inv_perspective: np.ndarray = field(default_factory=m3.identity4)
    view: np.ndarray = field(default_factory=m3.identity4)


def perspective(fov_deg: float, aspect: float, n: float, f: float):
    """Vulkan-style 0..1-depth projection + its inverse (camera.cpp:61-122).

    Returns (projection, inverse) as row-major matrices applied as M @ v.
    Note the caller (set_perspective) passes (zfar, znear) to get reverse-z.
    """
    focal_length = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    x = focal_length / aspect
    y = focal_length
    a = n / (f - n)
    b = f * a
    proj = np.array(
        [
            [x, 0.0, 0.0, 0.0],
            [0.0, y, 0.0, 0.0],
            [0.0, 0.0, a, b],
            [0.0, 0.0, -1.0, 0.0],
        ]
    )
    inv = np.array(
        [
            [1.0 / x, 0.0, 0.0, 0.0],
            [0.0, 1.0 / y, 0.0, 0.0],
            [0.0, 0.0, 0.0, -1.0],
            [0.0, 0.0, 1.0 / b, a / b],
        ]
    )
    return proj, inv


class CameraType:
    lookat = 0
    firstperson = 1


@dataclass
class Camera:
    name: str = ""
    node: int = -1
    type: int = CameraType.firstperson
    fov: float = 45.0
    znear: float = 0.1
    zfar: float = 100000.0
    aspect: float = 4.0 / 3.0
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    orientation: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))
    rotation_speed: float = 0.025
    movement_speed: float = 1.0
    matrices: CameraMatrices = field(default_factory=CameraMatrices)

    def __post_init__(self) -> None:
        self.update_view_matrix()
        self.set_perspective(self.fov, self.aspect, self.znear, self.zfar)

    # --- view ---
    def update_view_matrix(self) -> None:
        rot = m3.quat_to_mat4(self.orientation)
        trans = m3.translate(-np.asarray(self.position, dtype=np.float64))
        if self.type == CameraType.firstperson:
            self.matrices.view = rot @ trans
        else:
            self.matrices.view = trans @ rot

    def get_front(self) -> np.ndarray:
        return m3.quat_rotate(m3.quat_conjugate(self.orientation), [0.0, 0.0, -1.0])

    def get_up(self) -> np.ndarray:
        return m3.quat_rotate(m3.quat_conjugate(self.orientation), [0.0, 1.0, 0.0])

    def get_right(self) -> np.ndarray:
        return m3.quat_rotate(m3.quat_conjugate(self.orientation), [1.0, 0.0, 0.0])

    # --- projection ---
    def set_perspective(self, fov: float, aspect: float, znear: float, zfar: float) -> None:
        self.fov, self.aspect, self.znear, self.zfar = fov, aspect, znear, zfar
        # near/far swapped for reverse z (camera.cpp:124-131)
        p, inv = perspective(fov, aspect, zfar, znear)
        self.matrices.perspective = p
        self.matrices.inv_perspective = inv

    def update_aspect_ratio(self, aspect: float) -> None:
        self.set_perspective(self.fov, aspect, self.znear, self.zfar)

    # --- controls (CameraController parity, src/app/main.cpp:16-248) ---
    def set_position(self, position) -> None:
        self.position = np.asarray(position, dtype=np.float64)
        self.update_view_matrix()

    def set_rotation(self, q) -> None:
        self.orientation = m3.quat_normalize(q)
        self.update_view_matrix()

    def rotate(self, right_angle_deg: float, up_angle_deg: float) -> None:
        a = m3.quat_axis_angle([1.0, 0.0, 0.0], np.radians(up_angle_deg) * self.rotation_speed)
        b = m3.quat_axis_angle([0.0, 1.0, 0.0], np.radians(right_angle_deg) * self.rotation_speed)
        self.orientation = m3.quat_normalize(m3.quat_mul(m3.quat_mul(a, self.orientation), b))
        self.update_view_matrix()

    def translate(self, delta) -> None:
        self.position = self.position + m3.quat_rotate(m3.quat_conjugate(self.orientation), delta)
        self.update_view_matrix()

    def look_at(self, eye, target, up=(0.0, 1.0, 0.0)) -> None:
        self.position = np.asarray(eye, dtype=np.float64)
        self.orientation = m3.look_at_quat(eye, target, up)
        self.update_view_matrix()

    # --- launch params (OptixRender.cpp:953-954) ---
    def view_to_world(self) -> np.ndarray:
        return np.linalg.inv(self.matrices.view)

    def clip_to_view(self) -> np.ndarray:
        return self.matrices.inv_perspective
