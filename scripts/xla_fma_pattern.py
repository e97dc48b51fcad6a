#!/usr/bin/env python3
"""Which products XLA's CPU backend contracts into FMAs in one fusion.

    XLA_FLAGS=--xla_dump_to=DIR python3 scripts/gen_goldens.py hair_long   # (stop it once DIR fills)
    python3 scripts/xla_fma_pattern.py DIR/<module>.<fusion>_kernel_module.ir-with-opt.ll [...]

XLA's CPU backend emits each fusion as an LLVM module whose IR carries no
`contract` flag: the contraction happens in LLVM's DAG combine, by the
target's rules, on a non-aggressive x86 target without reassociation. For
each `ir-with-opt.ll` given, this script takes the function with the most
float operations, applies those rules by the IR's use counts (fadd(x*y, z)
-> fma(x, y, z) when the product has one use, the first operand tried
first; fsub(x*y, z) -> fma(x, y, -z); fsub(x, y*z) -> fma(-y, z, x); of two
products the one with fewer uses), and prints the expression of every
stored value and of every value used more than once, loads as L%n, with the
count of contractions. Where the fusion's object file sits beside it
(`obj-file.<fusion>_kernel_module.o`), it also prints the `vfmadd`,
`vfmsub`, `vfnmadd` and `vfnmsub` instructions `objdump -d` finds there: the
two counts agree (an unrolled loop multiplies the object's). A comparison
`x - y > 0` whose difference has one use reads `[x ogt y]`: LLVM folded the
subtraction away. Used to write the port's round-cone closed form and
camera rays (ROADMAP C.5).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from collections import Counter

_DEF = re.compile(r"^\s+(%[\w.]+) = (.*)$")
_OPERAND = re.compile(r"(%[\w.]+|0x[0-9A-F]+|-?\d+\.\d+e[+-]\d+)")


def _main_function(path: str) -> list:
    """The lines of the module's function with the most float operations."""
    funcs, cur = [], None
    for line in open(path):
        if line.startswith("define"):
            cur = []
            funcs.append(cur)
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            cur.append(line)
    return max(funcs, key=lambda f: sum(("fmul" in line) or ("fadd" in line) for line in f))


def _operands(rhs: str) -> list:
    return _OPERAND.findall(rhs)


def contract(path: str):
    """-> (lines to print, contractions)."""
    defs, order, stores = {}, [], []
    for line in _main_function(path):
        line = re.sub(r", align \d+", "", re.sub(r", !\w+(\.\w+)? !\d+", "", line.rstrip()))
        m = _DEF.match(line)
        if m:
            defs[m.group(1)] = m.group(2)
            order.append(m.group(1))
        elif line.strip().startswith("store float"):
            stores.append(line.strip())
    uses = Counter(o for n in order for o in _operands(defs[n]) if o.startswith("%"))
    uses.update(o for st in stores for o in _operands(st) if o.startswith("%"))

    def op(n):
        return defs.get(n, "").split(" ")[0]

    def args(n):
        r = defs[n]
        return _operands(r)[:1] if r.startswith("fneg") else _operands(r)[:2]

    def single_product(n):
        return op(n) == "fmul" and uses[n] == 1

    fma = {}
    for n in order:
        if op(n) not in ("fadd", "fsub"):
            continue
        a, b = args(n)
        if op(n) == "fadd":
            if single_product(a):
                fma[n] = ("+", a, b)
            elif single_product(b):
                fma[n] = ("+", b, a)
        elif single_product(a) and not (single_product(b) and uses[a] > uses[b]):
            fma[n] = ("-z", a, b)
        elif single_product(b):
            fma[n] = ("-x", b, a)

    label, lines = {}, []

    def show(n):
        if not n.startswith("%") or n not in defs:
            return n
        if n in label:
            return label[n]
        r, o = defs[n], op(n)
        if o == "load":
            s = "L" + n
        elif n in fma:
            kind, m, z = fma[n]
            x, y = args(m)
            s = {"+": f"fma({show(x)}, {show(y)}, {show(z)})", "-z": f"fma({show(x)}, {show(y)}, -{show(z)})",
                 "-x": f"fma(-{show(x)}, {show(y)}, {show(z)})"}[kind]
        elif o in ("fadd", "fsub", "fmul", "fdiv"):
            a, b = args(n)
            s = f"({show(a)} {dict(fadd='+', fsub='-', fmul='*', fdiv='/')[o]} {show(b)})"
        elif o == "fneg":
            s = f"-({show(args(n)[0])})"
        elif o == "fcmp":
            a, b = _operands(r)[:2]
            s = f"[{show(a)} {r.split(' ')[1]} {show(b)}]"
        elif o == "select":
            c, a, b = (p.strip().split(" ")[-1] for p in r[len("select "):].split(",")[:3])
            s = f"sel({show(c)}, {show(a)}, {show(b)})"
        elif o in ("tail", "call"):
            s = re.search(r"@([\w.]+)", r).group(1) + "(" + ", ".join(show(x) for x in _operands(r)) + ")"
        elif o in ("and", "or"):
            a, b = _operands(r)[:2]
            s = f"({show(a)} {o} {show(b)})"
        else:
            s = f"<{r[:40]}>"
        if uses[n] > 1 and o != "load":
            label[n] = n
            lines.append(f"{n} (x{uses[n]}) = {s}")
            return n
        return s

    for st in stores:
        lines.append(f"STORE {show(_operands(st)[0])}")
    return lines, len(fma)


def object_fmas(path: str):
    """The FMA instructions of the fusion's object beside its IR, or None."""
    d, name = os.path.split(path)
    m = re.match(r"^(module_\d+\.[^.]+)\.(.+_kernel_module)\.ir-with-opt\.ll$", name)
    if not m:
        return None
    obj = os.path.join(d, f"{m.group(1)}.obj-file.{m.group(2)}.o")
    if not os.path.exists(obj):
        return None
    dis = subprocess.run(["objdump", "-d", obj], stdout=subprocess.PIPE, text=True, check=True).stdout
    return len(re.findall(r"\bvf(?:n)?m(?:add|sub)\d+[ps][sd]\b", dis))


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for path in sys.argv[1:]:
        lines, n = contract(path)
        found = object_fmas(path)
        print(f"# {os.path.basename(path)}: {n} contractions" +
              ("" if found is None else f"; {found} FMA instructions in its object"))
        print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
