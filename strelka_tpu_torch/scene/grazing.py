"""Triangle soups and rays that hunt the box tests' rounding edge.

The culled walks (kernels K2/K3 over 32-triangle groups, K5 over the BVH)
must find every hit the dense sweep finds. Möller–Trumbore's rounding is
largest for rays aimed exactly at shared vertices and edges and at
coplanar triangles, where a box face is flat; these generators make such
cases from a seed, in numpy (float32 arrays):

- `soup(kind, seed)`: 300 triangles, random or with duplicates ("dups"), a
  coplanar grid ("coplanar"), or the grid under larger coplanar triangles
  ("overlap");
- `aimed_rays(n, seed, targets)`: rays at given points (or random), with
  axis-parallel directions, dead lanes, tmin > 0 and exclude ids;
- `soup_case(kind, seed)`: a soup and 400 rays at its centroids
  ("grazing": the overlap soup, rays at the grid's vertices, edge
  midpoints and centroids);
- `plane_case(...)`: a coplanar grid (and overlaps) turned and scaled at
  random, with rays at its vertices, edge points and overlaps at chosen
  angles to the plane, down to the edge of the margin's domain and past it;
- `twin_tree(...)`: a BVH over a scene's triangles twice over, one copy a
  half (every hit a tie);
- `cone_face_case(...)`: round cones whose end spheres touch the faces of
  their own boxes and their cone tree's leaf and node boxes, and rays at
  those faces and at the boxes' corners;
- `cone_grazing_case(...)`: the same cones, or hair-like ones turned at
  random, and rays that graze a cone's own box or a leaf or node box's face
  at angles whose sine is log-uniform down to 1e-5.
"""

from __future__ import annotations

import numpy as np


def soup(kind: str, seed: int, n: int = 300):
    """-> v0, e1, e2 [n, 3] f32, mask [n] i32 (mask 1, 4 and 0; the last 7
    padding-like). "dups": 24 triangles each copied to two later ids in other
    groups (equal t, ties to the lowest id); "coplanar": a 10x10 grid of unit
    quads in the plane y = 0 split into triangles that share edges;
    "overlap": the grid and 40 larger triangles in the same plane over it."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    if kind == "dups":
        src = rng.choice(100, 24, replace=False)
        for k, s in enumerate(src):
            for dst in (120 + 3 * k, 200 + 3 * k):
                v0[dst], e1[dst], e2[dst] = v0[s], e1[s], e2[s]
    elif kind in ("coplanar", "overlap"):
        k = 0
        for ix in range(10):
            for iz in range(10):
                p = np.array([ix - 5.0, 0.0, iz - 5.0], np.float32)
                for a, b in (((1, 0, 0), (1, 0, 1)), ((1, 0, 1), (0, 0, 1))):
                    v0[k], e1[k], e2[k] = p, np.array(a, np.float32), np.array(b, np.float32)
                    k += 1
        for k in range(200, 240 if kind == "overlap" else 200):
            v0[k, 1] = e1[k, 1] = e2[k, 1] = 0.0
            e1[k] *= 3.0
            e2[k] *= 3.0
    mask = np.ones(n, np.int32)
    mask[rng.random(n) < 0.2] = 4
    mask[-7:] = 0
    return v0, e1, e2, mask


def aimed_rays(n: int, seed: int, targets=None, ntri: int = 300):
    """Rays aimed at `targets` (points) where given, else random; every
    eleventh axis-parallel, dead lanes, some tmin > 0, finite and infinite
    tmax, exclude ids below ntri -> o, d [n, 3], tmin, tmax [n] f32,
    exclude [n] i32."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-9, 9, (n, 3)).astype(np.float32)
    if targets is not None:
        d = targets[rng.integers(0, len(targets), n)] - o
    else:
        d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[::11] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(d[::11]))]  # axis-parallel
    tmin = np.where(np.arange(n) % 5 == 2, 1e-3, 0.0).astype(np.float32)
    tmax = rng.choice([1e16, 8.0, 20.0], n).astype(np.float32)
    tmax[::9] = 0.0  # dead lanes
    exclude = np.where(rng.random(n) < 0.2, rng.integers(0, ntri, n), -1).astype(np.int32)
    return o, d, tmin, tmax, exclude


def soup_case(kind: str, seed: int):
    """A soup and 400 rays at its triangles' centroids ("grazing": the
    "overlap" soup and rays at its grid's vertices, edge midpoints and
    centroids) -> (v0, e1, e2, mask), (o, d, tmin, tmax, exclude)."""
    v0, e1, e2, mask = soup("overlap" if kind == "grazing" else kind, seed)
    p = v0 + (e1 + e2) / 3.0
    if kind == "grazing":
        p = np.concatenate([v0[:200], v0[:200] + e1[:200] * np.float32(0.5), p[:240]])
    return (v0, e1, e2, mask), aimed_rays(400, seed + 1, p.astype(np.float32))


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))[None, :]


def plane_case(seed: int, scale: float, offset: float, nx: int, nz: int, overlap: bool, sin_min: float,
               n: int = 256):
    """A coplanar grid of nx x nz unit quads (two triangles each, sharing
    edges; with `overlap` also larger triangles in the same plane over it),
    turned at random, scaled by `scale` and moved `offset` away from the
    origin; rays aimed at its vertices, points on its edges and the overlaps'
    vertices, from both sides, at an angle to the plane whose sine is
    log-uniform in [sin_min, 1] (a few exactly in the plane's normal
    direction). -> (v0, e1, e2, mask), (o, d, tmin, tmax, exclude)."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = [], [], []
    for ix in range(nx):
        for iz in range(nz):
            p = np.array([ix - nx / 2, 0.0, iz - nz / 2])
            for a, b in (((1, 0, 0), (1, 0, 1)), ((1, 0, 1), (0, 0, 1))):
                v0.append(p)
                e1.append(np.array(a, float))
                e2.append(np.array(b, float))
    if overlap:
        for _ in range(max(2, nx * nz // 4)):
            p = np.array([rng.uniform(-nx / 2, nx / 2), 0.0, rng.uniform(-nz / 2, nz / 2)])
            a = np.array([rng.uniform(-2, 2), 0.0, rng.uniform(-2, 2)])
            b = np.array([rng.uniform(-2, 2), 0.0, rng.uniform(-2, 2)])
            v0.append(p)
            e1.append(a)
            e2.append(b)
    v0, e1, e2 = (np.asarray(x) for x in (v0, e1, e2))
    rot = _rotation(rng)
    shift = rng.normal(size=3)
    shift = shift / np.linalg.norm(shift) * offset
    world = lambda p: (p @ rot.T) * scale + shift  # noqa: E731
    p0, p1, p2 = world(v0), world(v0 + e1), world(v0 + e2)
    v0f = p0.astype(np.float32)
    e1f = (p1 - p0).astype(np.float32)
    e2f = (p2 - p0).astype(np.float32)
    verts = np.concatenate([p0, p1, p2])
    edges = np.concatenate([p0 + (p1 - p0) * rng.random((len(p0), 1)), p1 + (p2 - p1) * rng.random((len(p0), 1))])
    pts = np.concatenate([verts, edges])
    targets = pts[rng.integers(0, len(pts), n)]
    normal = rot[:, 1]
    s = np.exp(rng.uniform(np.log(sin_min), 0.0, n))
    s[::17] = 1.0
    inplane = rng.normal(size=(n, 3))
    inplane -= (inplane @ normal)[:, None] * normal[None, :]
    inplane /= np.linalg.norm(inplane, axis=1, keepdims=True)
    side = np.where(rng.random(n) < 0.5, 1.0, -1.0)[:, None]
    d = np.sqrt(1.0 - s * s)[:, None] * inplane + (s[:, None] * side) * normal[None, :]
    dist = scale * rng.uniform(0.5, 3.0 * max(nx, nz), n)[:, None]
    o = (targets - d * dist).astype(np.float32)
    d = d.astype(np.float32)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e16, np.float32)
    exclude = np.full(n, -1, np.int32)
    mask = np.ones(len(v0f), np.int32)
    return (v0f, e1f, e2f, mask), (o, d, tmin, tmax, exclude)


def twin_tree(threaded, ntri: int):
    """A tree that holds a scene's triangles twice over, each copy in its
    own half: from a ThreadedBvh (numpy, 5 arrays) over triangles 0..ntri-1,
    a ThreadedBvh whose root has two children with equal boxes, the left
    one the tree over the copies (ids ntri..2 ntri - 1) and the right one the
    tree over the originals. Every hit has a twin at equal t in the other
    half; a walk that meets the left half first (equal tnear: left) finds the
    higher id first, and only the rule "equal t, lower id" gives the dense
    sweep's answer. The triangle arrays go with it concatenated, [a; a]."""
    bb_min, bb_max, skip, start, count = (np.asarray(a) for a in threaded)
    n = bb_min.shape[0]
    half = lambda offset, first: (skip.astype(np.int64) + offset, np.where(count > 0, start + first, 0))  # noqa: E731
    l_skip, l_start = half(1, ntri)
    r_skip, r_start = half(1 + n, 0)
    return (np.concatenate([bb_min[:1], bb_min, bb_min]).astype(np.float32),
            np.concatenate([bb_max[:1], bb_max, bb_max]).astype(np.float32),
            np.concatenate([[2 * n + 1], l_skip, r_skip]).astype(np.int32),
            np.concatenate([[0], l_start, r_start]).astype(np.int32),
            np.concatenate([[0], count, count]).astype(np.int32))


def cone_face_case(seed: int, scale: float, shift: float, m: int = 2048, n: int = 2000):
    """Cones along the axes (their own boxes and the tight leaf and node
    boxes of the cone tree over them, ops/curves.py:cone_tree, whose faces
    the end spheres touch) and rays aimed at the boxes' corners and at the
    spheres' extreme points,
    which lie on those faces; a third of the rays start in a face's plane and
    run along it -> (geometry [M_pad, 8], tree boxes [8, total], o [n, 3],
    d [n, 3]), f32."""
    from strelka_tpu_torch.ops import curves as C

    rng = np.random.default_rng(seed)
    a = (rng.uniform(-3, 3, (m, 3)) * scale + shift).astype(np.float32)
    b = a.copy()
    b[np.arange(m), rng.integers(0, 3, m)] += (rng.uniform(0.2, 1.0, m) * scale).astype(np.float32)
    ra = (rng.uniform(0.05, 0.4, m) * scale).astype(np.float32)
    geom, tree = _cone_tree_case(C, a, b, ra, ra.copy())
    boxes = np.concatenate([_live_boxes(tree)[0:6], _cone_boxes(C, geom)], axis=1)
    faces = [boxes[0:3].T, boxes[3:6].T]
    for k in range(3):
        e = np.eye(3, dtype=np.float32)[k] * ra[:, None]
        faces += [a - e, a + e, b - e, b + e]
    targets = np.concatenate(faces).astype(np.float32)
    o = (rng.uniform(-6, 6, (n, 3)) * scale + shift).astype(np.float32)
    t = targets[rng.integers(0, len(targets), n)]
    in_plane = rng.random(n) < 0.3
    k = rng.integers(0, 3, n)
    o[in_plane, k[in_plane]] = t[in_plane, k[in_plane]]
    d = t - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return geom, tree, o, d


def _cone_tree_case(C, a, b, ra, rb):
    """Cones in their given order, packed -> (geometry [M_pad, 8], tree boxes [8, total])."""
    m = a.shape[0]
    cones = C.FlatCones(a, b, ra, rb, np.arange(m, dtype=np.int32), np.zeros(m, np.float32), np.ones(m, np.float32))
    geom = C.cone_major_rows(C.pack_cones(cones, tblk=C.CONE_LEAF, super_=1)[0])
    return geom, C.cone_tree(geom).numpy()


def _live_boxes(tree):
    """The tree's boxes that hold a live cone (padding boxes are inverted)."""
    return tree[:, (tree[3:6] >= tree[0:3]).all(axis=0)]


def _cone_boxes(C, geom):
    """Each live cone's own box (ops/curves.py:cone_boxes), [6, live]."""
    return C.cone_boxes(geom).numpy()[0:6, geom[:, C.GEOM_RA] >= 0.0]


def cone_grazing_case(seed: int, scale: float, shift: float, hair: bool, m: int = 2048, n: int = 2000,
                      sin_min: float = 1e-5):
    """Round cones under the cone tree (ops/curves.py:cone_tree; hair: thin
    cones of radius 0.002-0.006 turned at random, else those of
    cone_face_case), and rays that cross a leaf or node box's face or a
    cone's own box's face (half each) at a random point, an edge or a
    corner of it, at an angle to the face whose
    sine is log-uniform in [sin_min, 1], from 2-10 box sizes away ->
    (geometry [M_pad, 8], tree boxes [8, total], o [n, 3], d [n, 3]), f32."""
    from strelka_tpu_torch.ops import curves as C

    rng = np.random.default_rng(seed)
    if hair:
        a = rng.uniform(-0.05, 0.05, (m, 3))
        axis = rng.normal(size=(m, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        b = a + axis * rng.uniform(0.005, 0.03, m)[:, None]
        ra = rng.uniform(0.002, 0.006, m)
        rb = ra * rng.uniform(0.8, 1.0, m)
        a, b, ra, rb = ((x * scale + (shift if x.ndim == 2 else 0.0)).astype(np.float32) for x in (a, b, ra, rb))
    else:
        a = (rng.uniform(-3, 3, (m, 3)) * scale + shift).astype(np.float32)
        b = a.copy()
        b[np.arange(m), rng.integers(0, 3, m)] += (rng.uniform(0.2, 1.0, m) * scale).astype(np.float32)
        ra = (rng.uniform(0.05, 0.4, m) * scale).astype(np.float32)
        rb = ra.copy()
    geom, tree = _cone_tree_case(C, a, b, ra, rb)
    nodes, own = _live_boxes(tree), _cone_boxes(C, geom)
    # half the rays at a leaf or node box, half at a cone's own box (which a leaf's walk tests)
    at_node = rng.random(n) < 0.5
    pick = np.where(at_node, rng.integers(0, nodes.shape[1], n), rng.integers(0, own.shape[1], n))
    lo = np.where(at_node[:, None], nodes[0:3, pick % nodes.shape[1]].T, own[0:3, pick].T).astype(np.float64)
    hi = np.where(at_node[:, None], nodes[3:6, pick % nodes.shape[1]].T, own[3:6, pick].T).astype(np.float64)
    k = rng.integers(0, 3, n)  # the face's axis
    side = rng.random(n) < 0.5
    u = rng.random((n, 3))
    u = np.where(rng.random((n, 3)) < 0.25, np.round(u), u)  # on an edge or a corner now and then
    p = lo + (hi - lo) * u
    rows_ = np.arange(n)
    p[rows_, k] = np.where(side, hi[rows_, k], lo[rows_, k])
    along = rng.normal(size=(n, 3))
    along[rows_, k] = 0.0
    along /= np.linalg.norm(along, axis=1, keepdims=True)
    sin = 10.0 ** rng.uniform(np.log10(sin_min), 0.0, n)
    normal = np.zeros((n, 3))
    normal[rows_, k] = np.where(side, -1.0, 1.0)  # into the box
    d = along * np.sqrt(1.0 - sin * sin)[:, None] + normal * sin[:, None]
    size = np.linalg.norm(hi - lo, axis=1) + 1e-3 * scale
    o = p - d * (size * rng.uniform(2.0, 10.0, n))[:, None]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return geom, tree, o.astype(np.float32), d.astype(np.float32)
