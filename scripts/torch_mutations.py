#!/usr/bin/env python3
"""Mutation check of the checks in chip_smoke.py: each mutant a copy of this
checkout with one deliberate fault, run once.

Run on a machine with one CUDA card, from the root of a checkout:

    python3 scripts/torch_mutations.py [--only NAME ...] [--out DIR]

Each mutant is a copy of the checkout in a fresh temporary directory
(outside the checkout; build outputs and `build/` left out), with one
textual change, and runs its check there: `chip_smoke.py`, or the card
test named in CHECKS. A mutant is caught when its check exits non-zero; the script prints one JSON line
per mutant (its name, exit code, seconds, and the check that failed: the
last AssertionError line) and writes each run's output to --out (default
build/mutations/<name>.log). It exits non-zero if a mutant is not caught or
a replacement does not apply.

Mutants:
  k5_no_lower_id  K5 keeps the first hit of equal t (no "equal t, the lower
                  id" rule): the tie tables must catch it;
  k5_pop_ge       K5's pop drops an entry whose tnear equals best t: its
                  results stay right (the margin puts a box's tnear below
                  every hit in it), so the per-ray counters must catch it
                  wherever a pushed tnear meets best t (the tie table's cut
                  rays, tmax at a leaf box's lowered tnear, make such rays);
  margin_zero     the box test's pad and slack set to 0 in both twins
                  (csrc/common.cuh and ops/slab.py): the reference's exact
                  test; the grazing soup must catch it;
  k6_margin_zero  K6 alone back on the reference's exact slab test, in the
                  kernel and in its plain twin (the near-to-far walk of
                  ops/bvh.py with any_hit=True; K5's stays on the margin):
                  the brute-force check of the grazing phase must catch it
                  inside the margin's domain;
  k6_no_push      K6 drops the farther child instead of pushing it, in the
                  kernel and in its plain twin: the check against K3
                  cull=False must catch it;
  k1_column_flip  one bit of one compiled-in column of K1 (dimension 2, bit
                  5) flipped: K1's bit-equality with its plain version must
                  catch it;
  k9_ties_high    K9's sort orders equal keys by the higher index first: the
                  order check against the plain twin must catch it;
  k4_vec_short    K4's 16-byte row path drops the last word of each row's
                  last chunk: the bit-equality at the main path's widths
                  must catch it;
  k10_p_spec_swapped  K10's OmniPBR lobe probability clamped with its
                  bounds swapped (always 0.05): K10's card test
                  (tests/test_torch_shade_bsdf_card.py) must catch it;
  k12_mis_swapped  K12's balance heuristic with its two pdfs swapped (the
                  light's weight given to the BSDF's sample): K11 and K12's
                  card test (tests/test_torch_shade_nee_card.py) must catch
                  it;
  k13_inside_flip_dropped  K13's geometric normal left unflipped on the lanes
                  that hit a triangle from inside: K13's card test
                  (tests/test_torch_shade_surface_card.py) must catch it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MUTANTS = {
    "k5_no_lower_id": [
        ("strelka_tpu_torch/csrc/bvh.cu", "(t < best_t || (t == best_t && prim < best_p))", "(t < best_t)"),
    ],
    "k5_pop_ge": [
        ("strelka_tpu_torch/csrc/bvh.cu", "if (!(stack_t[sp] > best_t)) {", "if (!(stack_t[sp] >= best_t)) {"),
    ],
    "margin_zero": [
        ("strelka_tpu_torch/csrc/common.cuh", "kStrelkaPad = 0x1p-13f", "kStrelkaPad = 0.0f"),
        ("strelka_tpu_torch/csrc/common.cuh", "kStrelkaSlack = 0x1p-20f", "kStrelkaSlack = 0.0f"),
        ("strelka_tpu_torch/ops/slab.py", "PAD = 2.0 ** -13", "PAD = 0.0"),
        ("strelka_tpu_torch/ops/slab.py", "SLACK = 2.0 ** -20", "SLACK = 0.0"),
    ],
    "k6_margin_zero": [
        ("strelka_tpu_torch/csrc/common.cuh", "constexpr float kStrelkaPad = 0x1p-13f;",
         """__device__ __forceinline__ float strelka_slab_exact(float lx, float ly, float lz, float hx, float hy, float hz,
                                                    float, float o0, float o1, float o2, float inv0, float inv1,
                                                    float inv2, float, float tn, float tfar) {
    const float x0 = (lx - o0) * inv0, x1 = (hx - o0) * inv0;
    const float y0 = (ly - o1) * inv1, y1 = (hy - o1) * inv1;
    const float z0 = (lz - o2) * inv2, z1 = (hz - o2) * inv2;
    const float t0 = fmaxf(fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1)), tn);
    const float t1 = fminf(fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1)), tfar);
    return t0 <= t1 ? t0 : INFINITY;
}
constexpr float kStrelkaPad = 0x1p-13f;"""),
        ("strelka_tpu_torch/csrc/bvh.cu", "float tl = strelka_slab_safe(__int_as_float(a.x)",
         "float tl = strelka_slab_exact(__int_as_float(a.x)"),
        ("strelka_tpu_torch/csrc/bvh.cu", "float tr = strelka_slab_safe(__int_as_float(b.z)",
         "float tr = strelka_slab_exact(__int_as_float(b.z)"),
        ("strelka_tpu_torch/ops/bvh.py",
         "tn = slab.slab_tnear([c[a] for c in oc], [c[a] for c in dc], tmn[a], best_t[a], boxes)",
         "tn = slab.slab_tnear([c[a] for c in oc], [c[a] for c in dc], tmn[a], best_t[a], boxes, "
         "**(dict(pad=0.0, slack=0.0) if any_hit else {}))"),
    ],
    "k6_no_push": [
        ("strelka_tpu_torch/csrc/bvh.cu", "                    stack[sp++] = left ? e.y : e.x;\n", ""),
        ("strelka_tpu_torch/ops/bvh.py", "sp[pa] += 1", "sp[pa] += 0 if any_hit else 1"),
    ],
    "k1_column_flip": [
        ("strelka_tpu_torch/csrc/sobol.cu", "0x5C000000u", "0x5C000001u"),
    ],
    "k9_ties_high": [
        ("strelka_tpu_torch/csrc/open_w.cu", "(k == key && f < e)", "(k == key && f > e)"),
    ],
    "k4_vec_short": [
        ("strelka_tpu_torch/csrc/gather.cu", "col[(f + 3) * kLanes] = v.w;", "if (f + 4 < cols) col[(f + 3) * kLanes] = v.w;"),
    ],
    "k10_p_spec_swapped": [
        ("strelka_tpu_torch/csrc/bsdf.cuh", "clamp(p_spec, SB_F(0.05), SB_F(0.95))",
         "clamp(p_spec, SB_F(0.95), SB_F(0.05))"),
    ],
    "k12_mis_swapped": [
        ("strelka_tpu_torch/csrc/nee.cu", "recip(1.0f + pdf / lpdf)", "recip(1.0f + lpdf / pdf)"),
    ],
    "k13_inside_flip_dropped": [
        ("strelka_tpu_torch/csrc/surface.cu", "fr.geom_normal = normalize(gcross) * flip;",
         "fr.geom_normal = normalize(gcross);"),
    ],
}
# a mutant's check where it is not chip_smoke.py (the interpreter's arguments)
CHECKS = {
    "k10_p_spec_swapped": ["-m", "pytest", "--noconftest", "-m", "card", "-q", "-x", "-p", "no:cacheprovider",
                           "tests/test_torch_shade_bsdf_card.py"],
    "k12_mis_swapped": ["-m", "pytest", "--noconftest", "-m", "card", "-q", "-x", "-p", "no:cacheprovider",
                        "tests/test_torch_shade_nee_card.py"],
    "k13_inside_flip_dropped": ["-m", "pytest", "--noconftest", "-m", "card", "-q", "-x", "-p", "no:cacheprovider",
                                "tests/test_torch_shade_surface_card.py"],
}
LEFT_OUT = shutil.ignore_patterns("build", "_build", ".git", "__pycache__")


def mutant_copy(name: str, root: str) -> str:
    """A copy of the checkout under `root` with the mutant's replacements applied."""
    tree = os.path.join(root, name)
    shutil.copytree(REPO, tree, ignore=LEFT_OUT)
    for path, old, new in MUTANTS[name]:
        full = os.path.join(tree, path)
        with open(full, encoding="utf-8") as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in {path} exactly once")
        with open(full, "w", encoding="utf-8") as f:
            f.write(text.replace(old, new))
    return tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(MUTANTS), default=sorted(MUTANTS))
    ap.add_argument("--out", default=os.path.join(REPO, "build", "mutations"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    missed = 0
    with tempfile.TemporaryDirectory(prefix="strelka_mutants_") as root:
        for name in args.only:
            tree = mutant_copy(name, root)
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, *CHECKS.get(name, ["chip_smoke.py"])], cwd=tree, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            with open(os.path.join(args.out, f"{name}.log"), "w") as f:
                f.write(run.stdout)
            failed = [line for line in run.stdout.splitlines() if re.match(r"\w*(Assertion|Runtime|Value)Error", line)]
            caught = run.returncode != 0
            missed += not caught
            print(json.dumps(dict(mutant=name, rc=run.returncode, caught=caught,
                                  seconds=round(time.perf_counter() - t0, 1),
                                  failed_at=failed[-1] if failed else None)), flush=True)
            shutil.rmtree(tree, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
