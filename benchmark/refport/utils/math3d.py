"""Host-side 3D math: 4x4 matrices (row-major, numpy) and quaternions.

Replaces the reference's vendored glm + sutil math (sutil/vec_math.h,
sutil/Matrix.h, sutil/Quaternion.h). All matrices here are ROW-MAJOR and
applied as ``M @ v`` — the same convention the reference's device code uses
after its glm(column-major)->sutil(row-major) transposes
(src/render/optix/OptixRender.cpp:953-954).

Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import numpy as np


def identity4() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(t) -> np.ndarray:
    m = identity4()
    m[:3, 3] = np.asarray(t, dtype=np.float64)
    return m


def scale(s) -> np.ndarray:
    s = np.asarray(s, dtype=np.float64)
    if s.ndim == 0:
        s = np.full(3, float(s))
    m = identity4()
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def quat_normalize(q) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q)


def quat_from_euler(angles_rad) -> np.ndarray:
    """XYZ-order Euler angles to quaternion — matches glm::quat(glm::vec3)."""
    x, y, z = np.asarray(angles_rad, dtype=np.float64) * 0.5
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    return np.array(
        [
            cx * cy * cz + sx * sy * sz,
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
        ]
    )


def quat_axis_angle(axis, angle_rad: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle_rad * 0.5
    return np.concatenate([[np.cos(half)], np.sin(half) * axis])


def quat_mul(a, b) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_conjugate(q) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    return np.array([q[0], -q[1], -q[2], -q[3]])


def quat_rotate(q, v) -> np.ndarray:
    """Rotate vector v by quaternion q (q * v * q^-1)."""
    qv = np.array([0.0, *np.asarray(v, dtype=np.float64)])
    r = quat_mul(quat_mul(q, qv), quat_conjugate(q))
    return r[1:]


def quat_to_mat3(q) -> np.ndarray:
    w, x, y, z = quat_normalize(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_to_mat4(q) -> np.ndarray:
    m = identity4()
    m[:3, :3] = quat_to_mat3(q)
    return m


def mat4_from_quat_pos(q, pos) -> np.ndarray:
    m = quat_to_mat4(q)
    m[:3, 3] = np.asarray(pos, dtype=np.float64)
    return m


def quat_from_mat3(m) -> np.ndarray:
    """Rotation matrix (row-major, applied as M@v) to quaternion (w,x,y,z)."""
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return quat_normalize(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return quat_normalize(q)


def quat_slerp(a, b, u: float) -> np.ndarray:
    a = quat_normalize(a)
    b = quat_normalize(b)
    d = float(np.dot(a, b))
    if d < 0.0:
        b, d = -b, -d
    if d > 0.9995:
        return quat_normalize(a + u * (b - a))
    theta = np.arccos(d)
    return (np.sin((1 - u) * theta) * a + np.sin(u * theta) * b) / np.sin(theta)


def compose_trs(translation, rotation_quat, scale_vec) -> np.ndarray:
    """T * R * S — the node-local transform of scene.h:350-388."""
    return translate(translation) @ quat_to_mat4(rotation_quat) @ scale(scale_vec)


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply 4x4 (row-major) to [N,3] points."""
    pts = np.asarray(pts, dtype=np.float64)
    return pts @ m[:3, :3].T + m[:3, 3]


def transform_vectors(m: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """Apply rotation/scale part (w=0) to [N,3] vectors."""
    return np.asarray(vecs, dtype=np.float64) @ m[:3, :3].T


def transform_normals(m: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """Apply inverse-transpose to [N,3] normals (no renormalize here)."""
    it = np.linalg.inv(m[:3, :3]).T
    return np.asarray(normals, dtype=np.float64) @ it.T


def normalize(v: np.ndarray, axis: int = -1, eps: float = 1e-20) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), eps)


def look_at_quat(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Orientation quaternion for a camera at eye looking at target.

    Returns q such that the view matrix is R(q) @ T(-eye) (Camera convention,
    src/scene/camera.cpp:10-22 firstperson branch).
    """
    eye = np.asarray(eye, dtype=np.float64)
    f = normalize(np.asarray(target, dtype=np.float64) - eye)
    r = normalize(np.cross(f, np.asarray(up, dtype=np.float64)))
    u = np.cross(r, f)
    # rows of the world->view rotation
    rot = np.stack([r, u, -f])
    return quat_from_mat3(rot)
