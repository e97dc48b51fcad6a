"""Exact swept cubic B-spline hit refinement (phantom-intersector style) —
the PyTorch port of strelka_tpu/ops/curve_refine.py.

The reference uses OptiX's built-in ROUND_CUBIC_BSPLINE intersector
(OptixRender.cpp:554-560), which solves the exact swept-sphere envelope.
The broad phase flattens each cubic to CURVE_SUBDIV round cones
(ops/curves.py), so silhouettes and thin-strand self-shadowing are
chord-approximate. This module refines the winning candidate of the cone
sweep (kernel K7) to the EXACT envelope with a few Newton iterations of
per-lane elementwise math, after one [N]-row control-point fetch. It is
plain PyTorch: the JAX package has no kernel here either.

Envelope equations for a sphere of radius r(u) swept along C(u)
(Reshetov's phantom intersector formulation): a surface point P = o + t d
satisfies

    F(t,u) = |P - C(u)|^2 - r(u)^2          = 0      (on the sphere)
    G(t,u) = (P - C(u)) . C'(u) + r(u) r'(u) = 0      (envelope tangency)

Newton on the 2x2 system; the cone hit provides the (t0, u0) seed, which is
within O(h^2) of the root, so 3-5 iterations converge to f32 round-off.
Lanes that fail to converge (grazing rays, |J| ~ 0) keep their cone result —
refinement can only move a hit toward the exact surface.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refport.ops.vec import Vec3


def _bspline_coeffs(q0, q1, q2, q3):
    """Uniform cubic B-spline -> power-basis coefficients.

    C(u) = c0 + c1 u + c2 u^2 + c3 u^3 (same basis as ops/curves.bspline_basis,
    cf. cuda/curve.h CubicInterpolator::initializeFromBSpline)."""
    c0 = (q0 + 4.0 * q1 + q2) / 6.0
    c1 = (q2 - q0) * 0.5
    c2 = (q0 - 2.0 * q1 + q2) * 0.5
    c3 = (q3 - q0) / 6.0 + (q1 - q2) * 0.5
    return c0, c1, c2, c3


class RefineResult(NamedTuple):
    t: torch.Tensor  # [N] refined ray parameter
    u: torch.Tensor  # [N] refined spline parameter in [0,1]
    converged: torch.Tensor  # [N] bool — envelope residual below tolerance
    sphere_hit: torch.Tensor  # [N] bool — ray hits sphere(C(u), r(u)) at the
    # final u (exact ghost/graze decider when Newton fails to converge)
    t_sphere: torch.Tensor  # [N] entry t into that sphere (valid if sphere_hit)


def refine_curve_hit(
    ctrl,  # tuple of 4 Vec3 (or [N,3] rows) control points, per lane
    weights,  # tuple of 4 [N] radii control values
    origins: Vec3,
    directions: Vec3,
    t0: torch.Tensor,
    u0: torch.Tensor,
    iters: int = 5,
    tol: float = 1e-4,
) -> RefineResult:
    """Newton-refine per-lane candidate hits to the exact swept B-spline.

    ctrl/weights are the WINNING segment's control data already gathered per
    lane ([N] rows)."""
    p0, p1, p2, p3 = (c if isinstance(c, Vec3) else Vec3(c[:, 0], c[:, 1], c[:, 2]) for c in ctrl)
    w0, w1, w2, w3 = weights

    # power-basis coefficients per component ([N] each)
    cs = [_bspline_coeffs(getattr(p0, ax), getattr(p1, ax), getattr(p2, ax), getattr(p3, ax))
          for ax in ("x", "y", "z")]
    rc = _bspline_coeffs(w0, w1, w2, w3)

    def curve_eval(u):
        u2 = u * u
        u3 = u2 * u
        pos = [c[0] + c[1] * u + c[2] * u2 + c[3] * u3 for c in cs]
        dpos = [c[1] + 2.0 * c[2] * u + 3.0 * c[3] * u2 for c in cs]
        d2pos = [2.0 * c[2] + 6.0 * c[3] * u for c in cs]
        r = rc[0] + rc[1] * u + rc[2] * u2 + rc[3] * u3
        dr = rc[1] + 2.0 * rc[2] * u + 3.0 * rc[3] * u2
        d2r = 2.0 * rc[2] + 6.0 * rc[3] * u
        return pos, dpos, d2pos, r, dr, d2r

    o = (origins.x, origins.y, origins.z)
    d = (directions.x, directions.y, directions.z)

    t, u = t0, torch.clamp(u0, 0.0, 1.0)
    for _ in range(iters):
        pos, dpos, d2pos, r, dr, d2r = curve_eval(u)
        w = [o[i] + t * d[i] - pos[i] for i in range(3)]  # P - C(u)
        w_dot_w = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
        w_dot_d = w[0] * d[0] + w[1] * d[1] + w[2] * d[2]
        w_dot_c1 = w[0] * dpos[0] + w[1] * dpos[1] + w[2] * dpos[2]
        w_dot_c2 = w[0] * d2pos[0] + w[1] * d2pos[1] + w[2] * d2pos[2]
        d_dot_c1 = d[0] * dpos[0] + d[1] * dpos[1] + d[2] * dpos[2]
        c1_dot_c1 = dpos[0] * dpos[0] + dpos[1] * dpos[1] + dpos[2] * dpos[2]

        F = w_dot_w - r * r
        G = w_dot_c1 + r * dr
        # Jacobian
        Ft = 2.0 * w_dot_d
        Fu = -2.0 * w_dot_c1 - 2.0 * r * dr
        Gt = d_dot_c1
        Gu = -c1_dot_c1 + w_dot_c2 + dr * dr + r * d2r
        det = Ft * Gu - Fu * Gt
        safe = torch.abs(det) > 1e-12
        inv = torch.where(safe, 1.0 / torch.where(safe, det, 1.0), 0.0)
        dt = (F * Gu - G * Fu) * inv
        du = (Ft * G - Gt * F) * inv
        # damped, clamped steps keep grazing lanes stable
        dt = torch.clamp(dt, -0.5 * torch.abs(t0) - 1e-3, 0.5 * torch.abs(t0) + 1e-3)
        du = torch.clamp(du, -0.25, 0.25)
        t = t - dt
        u = torch.clamp(u - du, 0.0, 1.0)

    # final residual check (scaled by r^2 so tolerance is scale-free)
    pos, dpos, _, r, dr, _ = curve_eval(u)
    w = [o[i] + t * d[i] - pos[i] for i in range(3)]
    F = (w[0] * w[0] + w[1] * w[1] + w[2] * w[2]) - r * r
    rel = torch.abs(F) / torch.clamp(r * r, min=1e-12)
    converged = (rel < tol) & (t > 0.0) & torch.isfinite(t)
    # exact ray-vs-sphere test at the final u: |d|=1, w = o - C(u).
    # Any point of the swept volume lies in SOME sphere of the family, so a
    # non-converged lane that still pierces sphere(u) is a true hit (t from
    # the sphere entry); one that misses it is an inflation ghost.
    wo = [o[i] - pos[i] for i in range(3)]
    b = wo[0] * d[0] + wo[1] * d[1] + wo[2] * d[2]
    cq = (wo[0] * wo[0] + wo[1] * wo[1] + wo[2] * wo[2]) - r * r
    disc = b * b - cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_sphere = -b - sq
    sphere_hit = (disc >= 0.0) & (t_sphere > 0.0) & torch.isfinite(t_sphere)
    return RefineResult(t=t, u=u, converged=converged, sphere_hit=sphere_hit, t_sphere=t_sphere)


def refine_scene_curve_hit(curves, origins: Vec3, directions: Vec3, t, seg, u, iters: int = 5):
    """Gather the winning segment's control data and refine.

    Returns (t, u, keep): converged lanes take the Newton root; non-converged
    lanes fall back to the exact sphere test at the final u (grazing hits
    keep the sphere-entry t); lanes that miss even that sphere are ghosts
    admitted only by the broad-phase radius inflation (flatten_curves_np)
    and report keep=False — the caller must turn them into misses.
    curves: DeviceCurves SoA (p0..p3 [S,3], w0..w3 [S])."""
    valid = seg >= 0
    sid = torch.clamp(seg, min=0).to(torch.int64)
    ctrl = tuple(Vec3(p[sid, 0], p[sid, 1], p[sid, 2]) for p in (curves.p0, curves.p1, curves.p2, curves.p3))
    weights = tuple(w[sid] for w in (curves.w0, curves.w1, curves.w2, curves.w3))
    res = refine_curve_hit(ctrl, weights, origins, directions, t, u, iters=iters)
    graze = ~res.converged & res.sphere_hit
    rt = torch.where(res.converged, res.t, torch.where(graze, res.t_sphere, t))
    ru = torch.where(res.converged | graze, res.u, u)
    keep = ~valid | res.converged | graze
    return torch.where(valid, rt, t), torch.where(valid, ru, u), keep
