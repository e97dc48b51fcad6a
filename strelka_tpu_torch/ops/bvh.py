"""BVH: host-side binned-SAH build + the plain lockstep traversal.

The PyTorch counterpart of strelka_tpu/ops/bvh.py. The build is host numpy
(or the C++ twin in strelka_tpu_torch/native), the same algorithm and node
format as the reference:

  * a single-level BVH over the world-space triangle soup, 16-bin SAH,
    leaves of at most MAX_LEAF triangles;
  * triangles are reordered leaf-contiguous, so a leaf is a (start, count)
    range and callers permute every per-triangle array by the build's
    permutation;
  * `thread_bvh` re-lays the nodes in DFS order with skip links: entering
    node i continues at i + 1, a box miss or a finished leaf jumps to
    skip[i], and skip[last] == n ends the walk. In this layout the left
    child of i is i + 1 and the right child is skip[i + 1].

`intersect_bvh_plain` is the reference's lockstep stackless walk,
operation for operation in f32, over component-array rays (with
margin=True on the port's box test: the yardstick of kernel K6's bound).
Kernels K5 and K6 (kernels/bvh.py, csrc/bvh.cu) walk near to far over a
second table made from the same tree, `child_rows` (each internal node's
two child boxes and references in one 64-byte row), with a short stack;
`intersect_bvh_ordered_plain` is their plain version (K6: any_hit=True).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch import log
from strelka_tpu_torch.ops import slab
from strelka_tpu_torch.utils import profiling as P

MAX_LEAF = 4
MISS_T = 1e16
# f32 operations of one slab test: per axis two subtractions, two products,
# a min and a max (18), two maxes and a max against tmin for tnear, two mins
# and a min against the best t for tfar (6).
SLAB_FLOPS = 24
_COUNT_BITS = 3  # packed node row: count <= MAX_LEAF fits; start < 2^28
# child_rows: 16 int32 a row (64 bytes, four 16-byte loads): the left child's
# box (lo xyz, hi xyz), the right child's box, the two child references and
# the two boxes' scales (ops/slab.py:box_scale) as f32 bits
CHILD_COLS = 16
STACK = 64  # entries of K5's and K6's per-thread stack (csrc/bvh.cu:kStack); a deeper tree is refused


class BvhNodes(NamedTuple):
    """The built tree (numpy, [n] per field); count == 0 marks an internal node."""

    bb_min: np.ndarray  # [n,3] f32
    bb_max: np.ndarray  # [n,3] f32
    left: np.ndarray  # [n] i32
    right: np.ndarray  # [n] i32
    start: np.ndarray  # [n] i32
    count: np.ndarray  # [n] i32


class ThreadedBvh(NamedTuple):
    """Stackless (skip-link) BVH in DFS order, numpy on the host."""

    bb_min: np.ndarray  # [n,3] f32
    bb_max: np.ndarray  # [n,3] f32
    skip: np.ndarray  # [n] i32
    start: np.ndarray  # [n] i32
    count: np.ndarray  # [n] i32 (0 = internal)


@dataclasses.dataclass(frozen=True)
class DeviceBvh:
    """A ThreadedBvh on one device as the packed node rows of `pack_nodes`,
    the child table made from them (`child_rows`) with the tree's depth,
    and how the tree came to be. Kernels K5 and K6 and their
    plain versions walk the child table, the reference's DFS walk
    (`intersect_bvh_plain`) the packed rows; the ThreadedBvh fields are
    views of the rows (start and count are unpacked on each access)."""

    nodes: torch.Tensor  # [n,8] i32: pack_nodes rows
    builder: str = "carried"  # "native", "numpy", or "carried" (arrays from elsewhere)
    children: Optional[torch.Tensor] = None  # [m, CHILD_COLS] i32: child_rows of `nodes`, K5's table
    depth: int = 0  # internal nodes on the longest root-to-leaf path: the stack K5's and K6's walks need

    @property
    def num_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def bb_min(self) -> torch.Tensor:  # [n,3] f32
        return self.nodes[:, 0:3].view(torch.float32)

    @property
    def bb_max(self) -> torch.Tensor:  # [n,3] f32
        return self.nodes[:, 3:6].view(torch.float32)

    @property
    def skip(self) -> torch.Tensor:  # [n] i32
        return self.nodes[:, 6]

    @property
    def start(self) -> torch.Tensor:  # [n] i32
        return self.nodes[:, 7] >> _COUNT_BITS

    @property
    def count(self) -> torch.Tensor:  # [n] i32 (0 = internal)
        return self.nodes[:, 7] & ((1 << _COUNT_BITS) - 1)


# ---------------------------------------------------------------------------
# Host build
# ---------------------------------------------------------------------------


def _build(v0, e1, e2, max_leaf):
    """(nodes, permutation, which builder ran: "native" or "numpy")."""
    from strelka_tpu_torch.native import native_build_bvh

    out = native_build_bvh(v0, e1, e2, max_leaf)
    name = "native" if out is not None else "numpy"
    log.info("BVH builder: {}", name)
    if out is None:
        out = _build_bvh_numpy(v0, e1, e2, max_leaf)
    return out[0], out[1], name


def build_bvh_sah(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, max_leaf: int = MAX_LEAF
) -> Tuple[BvhNodes, np.ndarray]:
    """Build a binned-SAH BVH. Returns (nodes, permutation).

    permutation[i] = original index of the triangle at reordered slot i;
    callers must reorder ALL per-triangle arrays with it. The C++ builder
    runs where a toolchain is present, else the numpy one (their trees
    differ: f32 against f64 arithmetic); the log says which ran."""
    return _build(v0, e1, e2, max_leaf)[:2]


def _build_bvh_numpy(v0, e1, e2, max_leaf):
    n = v0.shape[0]
    p0 = v0.astype(np.float64)
    p1 = p0 + e1
    p2 = p0 + e2
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    centroid = (tri_min + tri_max) * 0.5

    order = np.arange(n, dtype=np.int64)
    # flat node storage grown as we go
    bb_min, bb_max, left, right, start, count = [], [], [], [], [], []

    def new_node():
        bb_min.append(np.zeros(3))
        bb_max.append(np.zeros(3))
        left.append(0)
        right.append(0)
        start.append(0)
        count.append(0)
        return len(bb_min) - 1

    NBINS = 16
    # iterative stack of (node_id, lo, hi) over `order` slices
    root = new_node()
    stack = [(root, 0, n)]
    while stack:
        node_id, lo, hi = stack.pop()
        idx = order[lo:hi]
        nb_min = tri_min[idx].min(axis=0)
        nb_max = tri_max[idx].max(axis=0)
        bb_min[node_id] = nb_min
        bb_max[node_id] = nb_max
        num = hi - lo
        if num <= max_leaf:
            start[node_id] = lo
            count[node_id] = num
            continue
        cmin = centroid[idx].min(axis=0)
        cmax = centroid[idx].max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            # degenerate spread: median split
            mid = lo + num // 2
        else:
            # binned SAH
            scale = NBINS * (1.0 - 1e-6) / ext[axis]
            bins = ((centroid[idx, axis] - cmin[axis]) * scale).astype(np.int32)
            bins = np.clip(bins, 0, NBINS - 1)
            cnt = np.bincount(bins, minlength=NBINS)
            # per-bin bounds
            binf_min = np.full((NBINS, 3), np.inf)
            binf_max = np.full((NBINS, 3), -np.inf)
            for b in range(NBINS):
                sel = bins == b
                if sel.any():
                    binf_min[b] = tri_min[idx[sel]].min(axis=0)
                    binf_max[b] = tri_max[idx[sel]].max(axis=0)
            # sweep areas
            lcnt = np.cumsum(cnt)[:-1]
            rcnt = num - lcnt
            lmin = np.minimum.accumulate(binf_min, axis=0)[:-1]
            lmax = np.maximum.accumulate(binf_max, axis=0)[:-1]
            rmin = np.minimum.accumulate(binf_min[::-1], axis=0)[::-1][1:]
            rmax = np.maximum.accumulate(binf_max[::-1], axis=0)[::-1][1:]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = area(lmin, lmax) * lcnt + area(rmin, rmax) * rcnt
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if not np.isfinite(cost[best]):
                mid = lo + num // 2
            else:
                sel_left = bins <= best
                # partition order[lo:hi]
                order[lo:hi] = np.concatenate([idx[sel_left], idx[~sel_left]])
                mid = lo + int(sel_left.sum())
        if mid == lo or mid == hi:
            mid = lo + num // 2
            # re-sort by centroid for median split
            idx = order[lo:hi]
            key = np.argsort(centroid[idx, axis], kind="stable")
            order[lo:hi] = idx[key]
        l_id = new_node()
        r_id = new_node()
        left[node_id] = l_id
        right[node_id] = r_id
        stack.append((r_id, mid, hi))
        stack.append((l_id, lo, mid))

    nodes = BvhNodes(
        bb_min=np.asarray(bb_min, np.float32),
        bb_max=np.asarray(bb_max, np.float32),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        start=np.asarray(start, np.int32),
        count=np.asarray(count, np.int32),
    )
    return nodes, order.astype(np.int64)


def thread_bvh(nodes: BvhNodes) -> ThreadedBvh:
    """Reorder a built BVH into DFS order and compute skip links (host).

    DFS position strictly increases during traversal (enter -> i+1,
    skip/finish -> skip[i] > i), so a ray visits each node at most once and
    the step count is bounded by num_nodes.
    """
    bb_min = np.asarray(nodes.bb_min)
    bb_max = np.asarray(nodes.bb_max)
    left = np.asarray(nodes.left)
    right = np.asarray(nodes.right)
    start = np.asarray(nodes.start)
    count = np.asarray(nodes.count)
    n = len(count)

    # subtree sizes (iterative post-order)
    size = np.ones(n, np.int64)
    stack = [(0, False)]
    while stack:
        node, processed = stack.pop()
        if processed:
            if count[node] == 0:
                size[node] = 1 + size[left[node]] + size[right[node]]
            continue
        stack.append((node, True))
        if count[node] == 0:
            stack.append((int(right[node]), False))
            stack.append((int(left[node]), False))

    # DFS emit with skip targets
    new_bb_min = np.empty_like(bb_min)
    new_bb_max = np.empty_like(bb_max)
    new_skip = np.empty(n, np.int32)
    new_start = np.empty(n, np.int32)
    new_count = np.empty(n, np.int32)
    pos = 0
    stack2 = [(0, n)]  # (old node, skip target in NEW ids)
    while stack2:
        node, skip_target = stack2.pop()
        my_pos = pos
        pos += 1
        new_bb_min[my_pos] = bb_min[node]
        new_bb_max[my_pos] = bb_max[node]
        new_skip[my_pos] = skip_target
        new_start[my_pos] = start[node]
        new_count[my_pos] = count[node]
        if count[node] == 0:
            l, r = int(left[node]), int(right[node])
            right_pos = my_pos + 1 + int(size[l])
            # children visited left-first: push right (deeper in stack) first
            stack2.append((r, skip_target))
            stack2.append((l, right_pos))
    assert pos == n
    return ThreadedBvh(
        bb_min=new_bb_min.astype(np.float32),
        bb_max=new_bb_max.astype(np.float32),
        skip=new_skip,
        start=new_start,
        count=new_count,
    )


# ---------------------------------------------------------------------------
# Device layout
# ---------------------------------------------------------------------------

def pack_nodes(bvh: ThreadedBvh) -> np.ndarray:
    """[n, 8] int32 rows of 32 bytes, two 16-byte loads a node in the
    kernels: the f32 bits of bb_min xyz and bb_max xyz, skip, and
    (start << 3) | count."""
    count = np.asarray(bvh.count, np.int64)
    start = np.asarray(bvh.start, np.int64)
    if count.size and (count.max() >= 1 << _COUNT_BITS or start.max() >= 1 << (31 - _COUNT_BITS)):
        raise ValueError("BVH leaf range does not fit the packed node row")
    rows = np.empty((count.shape[0], 8), np.int32)
    rows[:, 0:3] = np.ascontiguousarray(bvh.bb_min, np.float32).view(np.int32)
    rows[:, 3:6] = np.ascontiguousarray(bvh.bb_max, np.float32).view(np.int32)
    rows[:, 6] = np.asarray(bvh.skip, np.int32)
    rows[:, 7] = ((start << _COUNT_BITS) | count).astype(np.int32)
    return rows


def child_rows(rows: np.ndarray) -> Tuple[np.ndarray, int]:
    """Packed threaded rows [n, 8] (pack_nodes) -> (the child table
    [m, CHILD_COLS] int32, the tree's depth), built from the rows bit for bit.

    Row r belongs to the r-th internal node in DFS order (row 0 the root);
    its children in the threaded layout are i + 1 (left) and skip[i + 1]
    (right). Per child: its box's six f32 words as in its own packed row, a
    reference (an internal child: its row << 3, count 0; a leaf: its packed
    word start << 3 | count) and its box's scale |box|_inf as f32 bits. A
    tree that is one leaf gets one row: the leaf on the left and an inverted
    box (never entered) on the right. depth: the most internal nodes on a
    root-to-leaf path, so the most entries K5's stack holds at once (one
    push an internal node at most)."""
    rows = np.asarray(rows, np.int32)
    n = rows.shape[0]
    count = rows[:, 7] & ((1 << _COUNT_BITS) - 1)
    internal = np.nonzero(count == 0)[0]
    row_of = np.full(n, -1, np.int64)
    row_of[internal] = np.arange(internal.shape[0])
    ref = np.where(count == 0, (row_of << _COUNT_BITS).astype(np.int64), rows[:, 7].astype(np.int64))
    scale = np.abs(rows[:, 0:6].view(np.float32)).max(axis=1)  # |box|_inf, as ops/slab.py:box_scale
    if internal.shape[0] == 0:
        empty = np.array([1e30] * 3 + [-1e30] * 3, np.float32)
        out = np.zeros((1, CHILD_COLS), np.int32)
        out[0, 0:6], out[0, 6:12] = rows[0, 0:6], empty.view(np.int32)
        out[0, 12], out[0, 13] = rows[0, 7], 0
        out[0, 14:16] = np.array([scale[0], np.float32(1e30)], np.float32).view(np.int32)
        return out, 0
    left = internal + 1
    right = rows[left, 6].astype(np.int64)
    out = np.empty((internal.shape[0], CHILD_COLS), np.int32)
    out[:, 0:6] = rows[left, 0:6]
    out[:, 6:12] = rows[right, 0:6]
    out[:, 12] = ref[left].astype(np.int32)
    out[:, 13] = ref[right].astype(np.int32)
    out[:, 14] = scale[left].view(np.int32)
    out[:, 15] = scale[right].view(np.int32)
    depth = np.zeros(n, np.int64)  # internal ancestors of each node; children come after their parent in DFS order
    for i, l, r in zip(internal.tolist(), left.tolist(), right.tolist()):
        depth[l] = depth[r] = depth[i] + 1
    return out, int(depth.max())


def device_bvh(bvh: ThreadedBvh, device, builder: str = "carried") -> DeviceBvh:
    """Upload a ThreadedBvh (any 5 arrays in its field order): its packed
    rows and the child table made from them."""
    host = ThreadedBvh(
        bb_min=np.ascontiguousarray(bvh[0], np.float32),
        bb_max=np.ascontiguousarray(bvh[1], np.float32),
        skip=np.ascontiguousarray(bvh[2], np.int32),
        start=np.ascontiguousarray(bvh[3], np.int32),
        count=np.ascontiguousarray(bvh[4], np.int32),
    )
    rows = pack_nodes(host)
    children, depth = child_rows(rows)
    return DeviceBvh(nodes=torch.tensor(rows, device=device), builder=builder,
                     children=torch.tensor(children, device=device), depth=depth)


def build_threaded(v0, e1, e2):
    """build_bvh_sah + thread_bvh -> (ThreadedBvh, perm, builder name); the
    recorder's set-up span bvh.build (utils/profiling.py) times it."""
    with P.setup_span("bvh.build"):
        nodes, perm, builder = _build(v0, e1, e2, MAX_LEAF)
        threaded = thread_bvh(nodes)
    return threaded, perm, builder


# ---------------------------------------------------------------------------
# Plain traversal (the plain version of kernels K5 and K6)
# ---------------------------------------------------------------------------


class TraversalCounts(NamedTuple):
    """What a traversal did, summed over its rays (Python ints)."""

    nodes_visited: int  # slab tests made, in the walk's order
    nodes_overlapped: int  # of those, boxes the ray's [tmin, best t] overlaps
    tri_tests: int  # triangles of overlapped leaves that pass mask and exclude (any_hit: up to the first hit)
    steps: int  # lockstep iterations until the last ray finished
    nodes_touched: int  # distinct nodes some ray overlapped
    tris_touched: int  # distinct triangles some ray tested


def _slab_test(bmin, bmax, o, inv_d, tmin, tmax):
    """Ray-AABB slab test on [M] component triples -> hit [M] bool."""
    tlo, thi = [], []
    for k in range(3):
        t0 = (bmin[k] - o[k]) * inv_d[k]
        t1 = (bmax[k] - o[k]) * inv_d[k]
        tlo.append(torch.minimum(t0, t1))
        thi.append(torch.maximum(t0, t1))
    tnear = torch.maximum(torch.maximum(torch.maximum(tlo[0], tlo[1]), tlo[2]), tmin)
    tfar = torch.minimum(torch.minimum(torch.minimum(thi[0], thi[1]), thi[2]), tmax)
    return tnear <= tfar


def _tri_test(o, d, v0, e1, e2, tmin, tmax):
    """Single-triangle Möller–Trumbore per ray; o, d component triples [M],
    v0/e1/e2 [M,3] -> (t, u, v, hit)."""

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    v0c, e1c, e2c = v0.unbind(1), e1.unbind(1), e2.unbind(1)
    pvec = cross(d, e2c)
    det = dot(e1c, pvec)
    det_ok = torch.abs(det) > 1e-12
    inv_det = torch.where(det_ok, 1.0 / det, 0.0)
    tvec = (o[0] - v0c[0], o[1] - v0c[1], o[2] - v0c[2])
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1c)
    v = dot(d, qvec) * inv_det
    t = dot(e2c, qvec) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
    return t, u, v, hit


def intersect_bvh_plain(
    o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int,
    any_hit: bool = False, prime_t: Optional[torch.Tensor] = None, counts: bool = False, name: str = "",
    margin: bool = False,
):
    """Lockstep stackless traversal over the threaded BVH -> (t, prim, u, v).

    The reference's `intersect_bvh` on component-array rays: o and d are
    (x, y, z) triples of [N] f32, tmin/tmax [N] f32 (a lane with
    tmax <= tmin is dead and never walks), exclude [N] int32 or None. prim
    indexes the leaf-ordered triangle arrays, -1 on a miss (t = 1e16,
    u = v = 0). any_hit retires a lane at its first accepted leaf.

    Each step every walking lane tests its node's box against
    [tmin, best t], tests the leaf's triangles in order with a strict
    t < best t, and moves to node + 1 or skip[node]. A node is read as the
    kernels read it, one packed row of bvh.nodes. Lanes are worked on as a
    shrinking subset (bookkeeping only: no lane's arithmetic changes).

    prime_t starts best t at min(prime_t, tmax) instead of at tmax (used to
    count the nodes a ray must visit given its final t). counts=True appends a
    TraversalCounts to the result.

    The box test is the reference's exact slab test (`_slab_test`), or with
    margin=True the port's (ops/slab.py:slab_tnear: entered where the
    lowered tnear is finite), which kernel K6 runs."""
    if name:
        K.note_plain(name, tmin.device)
    n = tmin.shape[0]
    dev = tmin.device
    n_nodes = bvh.num_nodes
    last_tri = v0.shape[0] - 1
    out_t = tmax * 1.0 if prime_t is None else torch.minimum(prime_t, tmax)
    out_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros(n, dtype=torch.float32, device=dev)
    out_v = torch.zeros(n, dtype=torch.float32, device=dev)
    visited = overlapped = tri_tests = steps = 0
    if counts:
        node_flag = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
        tri_flag = torch.zeros(v0.shape[0], dtype=torch.bool, device=dev)

    lanes = torch.nonzero(tmax > tmin).squeeze(1)  # lanes still walking
    oc = [c[lanes] for c in o]
    dc = [c[lanes] for c in d]
    inv_d = [1.0 / torch.where(torch.abs(c) > 1e-20, c, 1e-20) for c in dc]
    tmn = tmin[lanes]
    ex = exclude[lanes] if exclude is not None else None
    node = torch.zeros(lanes.shape[0], dtype=torch.int32, device=dev)
    best_t, best_p, best_u, best_v = out_t[lanes], out_p[lanes], out_u[lanes], out_v[lanes]

    for _ in range(n_nodes + 1):
        m = lanes.shape[0]
        if m == 0:
            break
        steps += 1
        lane_active = node < n_nodes
        nodec = torch.clamp(node, max=n_nodes - 1).to(torch.int64)
        row = bvh.nodes[nodec]  # [m, 8]: bb_min, bb_max, skip, start << 3 | count
        if margin:
            boxes = torch.zeros((8, m, 1), dtype=torch.float32, device=dev)
            boxes[0:6, :, 0] = row[:, 0:6].view(torch.float32).T
            hit_box = slab.slab_tnear(oc, dc, tmn, best_t, boxes)[:, 0] < float("inf")
        else:
            box = row[:, 0:6].view(torch.float32).unbind(1)
            hit_box = _slab_test(box[0:3], box[3:6], oc, inv_d, tmn, best_t)
        cnt = row[:, 7] & ((1 << _COUNT_BITS) - 1)
        is_leaf = cnt > 0
        proc_leaf = lane_active & is_leaf & hit_box
        if counts:
            visited += int(lane_active.sum())
            overlapped += int((lane_active & hit_box).sum())
            node_flag[nodec[lane_active & hit_box]] = True
        at_leaf = torch.nonzero(proc_leaf).squeeze(1)
        if at_leaf.shape[0] > 0:
            lo = [c[at_leaf] for c in oc]
            ld = [c[at_leaf] for c in dc]
            l_tmin, l_cnt, l_start = tmn[at_leaf], cnt[at_leaf], row[at_leaf, 7] >> _COUNT_BITS
            l_ex = ex[at_leaf] if ex is not None else None
            lt, lp, lu, lv = best_t[at_leaf], best_p[at_leaf], best_u[at_leaf], best_v[at_leaf]
            for k in range(MAX_LEAF):
                prim = torch.clamp(l_start + k, max=last_tri)
                pi = prim.to(torch.int64)
                t, u, v, hit = _tri_test(lo, ld, v0[pi], e1[pi], e2[pi], l_tmin, lt)
                cand = (k < l_cnt) & ((mask[pi] & ray_mask) != 0)
                if l_ex is not None:
                    cand = cand & (prim != l_ex)
                if counts:
                    tested = cand & (lp < 0) if any_hit else cand  # K6 leaves the leaf at its first hit
                    tri_tests += int(tested.sum())
                    tri_flag[pi[tested]] = True
                hit = hit & cand
                lp = torch.where(hit, prim, lp)
                lu = torch.where(hit, u, lu)
                lv = torch.where(hit, v, lv)
                lt = torch.where(hit, t, lt)
            best_t[at_leaf], best_p[at_leaf], best_u[at_leaf], best_v[at_leaf] = lt, lp, lu, lv
        enter = lane_active & hit_box & ~is_leaf
        nxt = torch.where(enter, nodec.to(torch.int32) + 1, row[:, 6])
        node = torch.where(lane_active, nxt, node)
        if any_hit:
            node = torch.where(best_p >= 0, n_nodes, node).to(torch.int32)
        walking = node < n_nodes
        left_walking = int(walking.sum())
        if left_walking * 2 <= m:  # shrink the working set; finished lanes write back
            out_t[lanes], out_p[lanes], out_u[lanes], out_v[lanes] = best_t, best_p, best_u, best_v
            keep = torch.nonzero(walking).squeeze(1)
            lanes = lanes[keep]
            oc, dc, inv_d = ([c[keep] for c in cs] for cs in (oc, dc, inv_d))
            tmn, node = tmn[keep], node[keep]
            ex = ex[keep] if ex is not None else None
            best_t, best_p, best_u, best_v = best_t[keep], best_p[keep], best_u[keep], best_v[keep]
    out_t[lanes], out_p[lanes], out_u[lanes], out_v[lanes] = best_t, best_p, best_u, best_v
    out_t = torch.where(out_p >= 0, out_t, MISS_T)
    result = (out_t, out_p, out_u, out_v)
    if counts:
        return result + (TraversalCounts(visited, overlapped, tri_tests, steps, int(node_flag.sum()),
                                         int(tri_flag.sum())),)
    return result


# ---------------------------------------------------------------------------
# Plain near-to-far walk (the plain version of kernel K5)
# ---------------------------------------------------------------------------


class OrderedCounts(NamedTuple):
    """What the near-to-far walk did, per ray ([N] i32 each)."""

    nodes: torch.Tensor  # child boxes tested (two an internal node taken)
    tris: torch.Tensor  # triangles of the leaves taken that pass mask and exclude


def _child_boxes(rows):
    """Child table rows [m, CHILD_COLS] -> per-ray boxes [8, m, 2] (lo xyz, hi xyz, 0, 0) and refs [m, 2]."""
    f = rows[:, 0:12].view(torch.float32).reshape(-1, 2, 6)  # [m, child, lo xyz hi xyz]
    boxes = torch.zeros((8, rows.shape[0], 2), dtype=torch.float32, device=rows.device)
    boxes[0:6] = f.permute(2, 0, 1)
    return boxes, rows[:, 12:14]


def intersect_bvh_ordered_plain(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int,
                                counts: bool = False, name: str = "", any_hit: bool = False):
    """Kernel K5's walk in plain PyTorch -> (t, prim, u, v), each [N]; with
    counts=True also an OrderedCounts. With any_hit=True, kernel K6's walk:
    the same order and box test, a ray ends at the first triangle that
    Möller–Trumbore accepts, and (t, prim, u, v) are that hit's.

    Each live ray (tmax > tmin) starts at the root's row of bvh.children.
    At an internal node it tests both child boxes with the port's box test
    (ops/slab.py:slab_tnear) against [tmin, best t] (best t starts at
    tmax): it goes to the nearer entered child (of equal tnear the left,
    which holds the lower leaf ids) and pushes the farther one with its
    tnear on its stack, or goes to the one entered, or pops. At a leaf it
    tests the triangles in order (mask, exclude, Möller–Trumbore against
    [tmin, tmax]) and a hit replaces the best one on t < best t, or on
    equal t and a lower prim id; then it pops. A pop drops entries whose
    tnear is greater than best t (strict) and takes the first one left; an
    empty stack ends the walk. prim indexes the leaf-ordered triangles, -1
    on a miss (t = 1e16, u = v = 0). The lanes step in lockstep, one action
    each a step (bookkeeping only: every lane's sequence of actions and its
    arithmetic are the kernel's).

    any_hit: the leaf's triangles are tested in order up to the first hit
    (counted), which ends the ray's walk; best t stays tmax until then, so
    every box is tested against [tmin, tmax] and no pop drops an entry."""
    if name:
        K.note_plain(name, tmin.device)
    n = tmin.shape[0]
    dev = tmin.device
    table = bvh.children
    last_tri = v0.shape[0] - 1
    out_t = tmax * 1.0
    out_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros(n, dtype=torch.float32, device=dev)
    out_v = torch.zeros(n, dtype=torch.float32, device=dev)
    out_nodes = torch.zeros(n, dtype=torch.int32, device=dev)
    out_tris = torch.zeros(n, dtype=torch.int32, device=dev)

    lanes = torch.nonzero(tmax > tmin).squeeze(1)
    oc = [c[lanes] for c in o]
    dc = [c[lanes] for c in d]
    tmn, tmx = tmin[lanes], tmax[lanes]
    ex = exclude[lanes] if exclude is not None else None
    m = lanes.shape[0]
    node = torch.zeros(m, dtype=torch.int32, device=dev)  # a reference; -1: pop; -2: done
    sp = torch.zeros(m, dtype=torch.int64, device=dev)
    stack_ref = torch.zeros((m, max(bvh.depth, 1)), dtype=torch.int32, device=dev)
    stack_t = torch.zeros((m, max(bvh.depth, 1)), dtype=torch.float32, device=dev)
    best_t, best_p, best_u, best_v = tmx * 1.0, out_p[lanes], out_u[lanes], out_v[lanes]
    nodes, tris = out_nodes[lanes], out_tris[lanes]
    low = (1 << _COUNT_BITS) - 1
    inf = float("inf")

    while lanes.shape[0]:
        # ---- internal nodes: test both children, go near, push far
        a = torch.nonzero((node >= 0) & ((node & low) == 0))[:, 0]
        if a.shape[0]:
            boxes, refs = _child_boxes(table[(node[a] >> _COUNT_BITS).long()])
            tn = slab.slab_tnear([c[a] for c in oc], [c[a] for c in dc], tmn[a], best_t[a], boxes)  # [A, 2]
            tl, tr = tn[:, 0], tn[:, 1]
            inl, inr = tl < inf, tr < inf
            nodes[a] += 2
            go_left = tl <= tr
            both = inl & inr
            pa = a[both]
            at = sp[pa]
            stack_ref[pa, at] = torch.where(go_left, refs[:, 1], refs[:, 0])[both]
            stack_t[pa, at] = torch.where(go_left, tr, tl)[both]
            sp[pa] += 1
            nxt = torch.where(both, torch.where(go_left, refs[:, 0], refs[:, 1]),
                              torch.where(inl, refs[:, 0], torch.where(inr, refs[:, 1], -1)))
            node[a] = nxt
        # ---- leaves: test the triangles, then pop
        b = torch.nonzero((node >= 0) & ((node & low) != 0))[:, 0]
        if a.shape[0]:
            b = b[~torch.isin(b, a)]  # a lane takes one action a step
        if b.shape[0]:
            lo, ld = [c[b] for c in oc], [c[b] for c in dc]
            start, cnt = node[b] >> _COUNT_BITS, node[b] & low
            lt, lp, lu, lv = best_t[b], best_p[b], best_u[b], best_v[b]
            l_ex = ex[b] if ex is not None else None
            tested = torch.zeros_like(cnt)
            for k in range(MAX_LEAF):
                prim = torch.clamp(start + k, max=last_tri)
                pi = prim.to(torch.int64)
                cand = (k < cnt) & ((mask[pi] & ray_mask) != 0)
                if l_ex is not None:
                    cand = cand & (prim != l_ex)
                if any_hit:
                    cand = cand & (lp < 0)  # the leaf is left at its first hit
                tested += cand.to(torch.int32)
                t, u, v, hit = _tri_test(lo, ld, v0[pi], e1[pi], e2[pi], tmn[b], tmx[b])
                better = hit & cand & ((t < lt) | ((t == lt) & (prim < lp)))
                lt, lp = torch.where(better, t, lt), torch.where(better, prim, lp)
                lu, lv = torch.where(better, u, lu), torch.where(better, v, lv)
            best_t[b], best_p[b], best_u[b], best_v[b] = lt, lp, lu, lv
            tris[b] += tested
            node[b] = torch.where(lp >= 0, -2, -1).to(torch.int32) if any_hit else -1  # any hit: the walk ends
        # ---- pops: one entry a step; an entry beyond best t is dropped
        done = a.shape[0] + b.shape[0]
        c = torch.nonzero(node == -1)[:, 0]
        if done:
            c = c[~torch.isin(c, torch.cat([a, b]))]
        if c.shape[0]:
            has = sp[c] > 0
            cc = c[has]
            sp[cc] -= 1
            keep = ~(stack_t[cc, sp[cc]] > best_t[cc])
            node[cc[keep]] = stack_ref[cc[keep], sp[cc[keep]]]
            finished = c[~has]
            if finished.shape[0]:
                node[finished] = -2
        walking = node != -2
        if int(walking.sum()) * 2 <= lanes.shape[0]:  # shrink the working set; finished lanes write back
            out_t[lanes], out_p[lanes], out_u[lanes], out_v[lanes] = best_t, best_p, best_u, best_v
            out_nodes[lanes], out_tris[lanes] = nodes, tris
            keep = torch.nonzero(walking).squeeze(1)
            lanes = lanes[keep]
            oc, dc = [x[keep] for x in oc], [x[keep] for x in dc]
            tmn, tmx, node, sp = tmn[keep], tmx[keep], node[keep], sp[keep]
            ex = ex[keep] if ex is not None else None
            stack_ref, stack_t = stack_ref[keep], stack_t[keep]
            best_t, best_p, best_u, best_v = best_t[keep], best_p[keep], best_u[keep], best_v[keep]
            nodes, tris = nodes[keep], tris[keep]
    out_t = torch.where(out_p >= 0, out_t, MISS_T)
    result = (out_t, out_p, out_u, out_v)
    return result + (OrderedCounts(out_nodes, out_tris),) if counts else result
