#!/usr/bin/env python3
"""Instruction mix of the port's compiled CUDA kernels.

Run from the repository root on a machine with the CUDA toolkit:

    python3 scripts/kernel_sass_mix.py

Builds the kernels as chip_smoke.py does (strelka_tpu_torch/_build/), runs
`cuobjdump -sass` on each object and prints one JSON line per kernel: the
instructions outside any loop and, for each loop (a backward branch), its
address range and instructions (an outer loop's include its inner
loops'), each counted by opcode (NOPs and the self-branch that pads the
end left out). Instructions a lane issues = outside + sum of loop x trip
count; the trip
counts follow from the source (K1's 32-bit fold is unrolled 8 times: 4
trips; K2/K3's innermost loop runs once per triangle).
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(found):
        raise RuntimeError("cuobjdump not found: run this where the CUDA toolkit is installed")
    return found


def mix(sass: str) -> list[dict]:
    kernels = []
    for m in re.finditer(r"Function : (\S+)(.*?)(?=Function :|\Z)", sass, re.S):
        insns = [(int(a, 16), op.split(".")[0], args) for a, op, args in _INSN.findall(m.group(2))
                 if op != "NOP" and not (op == "BRA" and args.strip() == f"0x{a.lstrip('0')}")]  # end padding
        loops = []
        for addr, op, args in insns:
            target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                loops.append((int(target.group(1), 16), addr))
        in_loop = [any(lo <= a <= hi for lo, hi in loops) for a, _, _ in insns]
        kernels.append({
            "kernel": re.search(r"\d+([a-z_]+_kernel)", m.group(1)).group(1),
            "outside_loops": dict(collections.Counter(op for (_, op, _), inl in zip(insns, in_loop) if not inl)),
            "loops": [{"range": [hex(lo), hex(hi)],
                       "ops": dict(collections.Counter(op for a, op, _ in insns if lo <= a <= hi))}
                      for lo, hi in loops],
        })
    return kernels


def main() -> int:
    sys.path.insert(0, REPO)
    from strelka_tpu_torch.kernels import build

    build.load()
    out_dir = os.path.join(build.BUILD_ROOT, build._digest())
    for name in build.SOURCES:
        obj = os.path.join(out_dir, name.replace(".cu", ".o"))
        sass = subprocess.run([_cuobjdump(), "-sass", obj], stdout=subprocess.PIPE, text=True, check=True).stdout
        for k in mix(sass):
            print(json.dumps({"source": name, **k}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
