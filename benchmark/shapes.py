"""Mesh arrays the scene builders share: a frozen copy of the arithmetic of the
program's `scene/testscenes.py:_quad` and `_box`, so that a change there does
not move the benchmark's scenes."""

import numpy as np


def quad(p0, p1, p2, p3):
    """Two triangles for corners given CCW (normal = right-hand rule):
    (positions [4,3], indices [6], normals [4,3], uvs [4,2])."""
    pos = np.array([p0, p1, p2, p3], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    n = np.cross(pos[1] - pos[0], pos[2] - pos[0])
    n = n / np.linalg.norm(n)
    normals = np.tile(n[None, :], (4, 1)).astype(np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return pos, idx, normals, uvs


def box(center, size):
    """An axis-aligned box as 12 triangles with outward normals, in quad's arrays."""
    c = np.asarray(center, np.float64)
    x, y, z = np.asarray(size, np.float64) / 2
    # +x, -x, +y, -y, +z, -z
    faces = [
        ([x, -y, -z], [x, y, -z], [x, y, z], [x, -y, z]),
        ([-x, -y, z], [-x, y, z], [-x, y, -z], [-x, -y, -z]),
        ([-x, y, -z], [-x, y, z], [x, y, z], [x, y, -z]),
        ([-x, -y, z], [-x, -y, -z], [x, -y, -z], [x, -y, z]),
        ([-x, -y, z], [x, -y, z], [x, y, z], [-x, y, z]),
        ([x, -y, -z], [-x, -y, -z], [-x, y, -z], [x, y, -z]),
    ]
    parts = [quad(*[np.asarray(p) + c for p in f]) for f in faces]
    return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] + 4 * k for k, p in enumerate(parts)]),
            np.concatenate([p[2] for p in parts]), np.concatenate([p[3] for p in parts]))


def diffuse(side, name: str, color):
    """A `default.mdl` material of one colour, in `side`'s scene module."""
    return side.scene.MaterialDescription(type="mdl", file="default.mdl", name=name, has_color=True,
                                          color=np.asarray(color, np.float32))
