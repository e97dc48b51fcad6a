"""Build and load the port's CUDA kernels (csrc/*.cu -> one shared library).

Route: nvcc by hand into a shared library with a plain C interface, loaded
with ctypes. Each source compiles to an object in its own nvcc process, all
started together, and the objects link into `libstrelka_kernels.so`. The
build directory is keyed by a hash of the sources and flags, so a changed
source builds again and an unchanged one is loaded as it is. The
recorder (utils/profiling.py) keeps the set-up span kernels.load and counts
the sources built (kernels.built, by source) or the library loaded as it
was (kernels.loaded).

Flags: `sm_90a`, -O3, no fast math. The intersection sources also get
-fmad=false, so the slab tests, Möller–Trumbore and the round-cone closed
form round every product and sum on their own, as the CPU reference and the plain PyTorch versions do;
so do the surface, BSDF and NEE phases (surface.cu, shade.cu, nee.cu), as each elementwise PyTorch kernel
rounds its one operation.

Nothing here runs at import: `load()` builds on first use.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

from strelka_tpu_torch.utils import profiling as P

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libstrelka_kernels.so"

COMMON_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# per-source extra flags
SOURCES = {
    "sobol.cu": [],
    "gather.cu": [],
    "intersect.cu": ["-fmad=false"],
    "bvh.cu": ["-fmad=false"],
    "cones.cu": ["-fmad=false"],
    "open_w.cu": ["-fmad=false"],
    "shade.cu": ["-fmad=false"],
    "nee.cu": ["-fmad=false"],
    "surface.cu": ["-fmad=false"],
}
HEADERS = ["common.cuh", "bsdf.cuh"]

_VP = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C entry points: name -> argtypes (every entry returns cudaGetLastError())
SIGNATURES = {
    "strelka_random_dims": [_VP, _VP, _I64, ctypes.c_uint32, _I32, _I32, _VP],
    # 8 ray components, exclude, v0, e1, e2, mask, group boxes; ray mask, n, ntri, groups, cull, schedule; ray
    # counter, outputs, groups tested, stream
    "strelka_intersect_closest": [_VP] * 14 + [_I32, _I64, _I32, _I32, _I32, _I32] + [_VP] * 7,
    "strelka_intersect_any": [_VP] * 14 + [_I32, _I64, _I32, _I32, _I32, _I32] + [_VP] * 4,
    # 8 ray components, exclude, child rows; rows, depth; v0, e1, e2, mask; ray mask, n, ntri; t, prim, u, v,
    # nodes, tris, stream
    "strelka_bvh_closest": [_VP] * 10 + [_I32, _I32] + [_VP] * 4 + [_I32, _I64, _I32] + [_VP] * 7,
    # 8 ray components, exclude, child rows; rows, depth; triangle rows; ray mask, n, ntri; occ, nodes, tris, stream
    "strelka_bvh_any": [_VP] * 10 + [_I32, _I32, _VP, _I32, _I64, _I32] + [_VP] * 4,
    "strelka_gather_rows_t": [_VP, _VP, _VP, _I64, _I32, _I32, _VP],
    # 8 ray components, cone geometry, tree boxes, the levels' first boxes (a host array); levels, m_pad, cull;
    # n, blocks; ray counter, outputs, stats, slots, stream
    "strelka_cone_closest": [_VP] * 11 + [_I32] * 3 + [_I64, _I32] + [_VP] * 7,
    "strelka_cone_any": [_VP] * 11 + [_I32] * 3 + [_I64, _I32] + [_VP] * 5,
    # any hit; blocks per SM, threads a block
    "strelka_cone_occupancy": [_I32, _VP, _VP],
    # 8 ray components, superblock boxes, nsb, d2, r2t, tile, n; open, W, min_tn, order, tnear, count, stream
    "strelka_open_w": [_VP] * 9 + [_I32, _VP, _VP, _I32, _I64] + [_VP] * 7,
    # the inputs' and the outputs' pointers (host arrays, kernels/shade.py's orders), n, depth, variant, stream
    "strelka_shade_bsdf": [_VP, _VP, _I64, _I32, _I32, _VP],
    # the same pointers (kernels/nee.py's orders), the light table and its rows, n; num_lights, the rect method
    # (K11) or the variant (K12); stream
    "strelka_nee_light": [_VP, _VP, _VP, _I32, _I64, _I32, _I32, _VP],
    "strelka_nee_shade": [_VP, _VP, _VP, _I32, _I64, _I32, _VP],
    # the lanes' pointers (kernels/surface.py's orders), the tables' pointers; the attr and material tables' rows,
    # the curve segments, n; num_lights, depth, the instance (curves, refine, uv); stream
    "strelka_shade_surface": [_VP, _VP, _VP, _I32, _I32, _I32, _I64] + [_I32] * 5 + [_VP],
    "strelka_error_string": [_I32],
}


class Built:
    lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    h.update(repr((COMMON_FLAGS, sorted(SOURCES.items()))).encode())
    for name in sorted(list(SOURCES) + HEADERS):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _build(out_dir: str) -> None:
    nvcc = _nvcc()
    procs = []
    for name, extra in SOURCES.items():
        obj = os.path.join(out_dir, name.replace(".cu", ".o"))
        cmd = [nvcc, *COMMON_FLAGS, *extra, "-Xptxas", "-v", "-c", os.path.join(CSRC, name), "-o", obj]
        procs.append((name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed, objs = [], []
    for name, obj, p in procs:
        out, _ = p.communicate()
        with open(os.path.join(out_dir, name + ".log"), "wb") as f:
            f.write(out)
        if p.returncode != 0:
            failed.append(f"{name}:\n{out.decode(errors='replace')}")
        objs.append(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = os.path.join(out_dir, LIB_NAME + ".tmp")
    link = subprocess.run([nvcc, *COMMON_FLAGS, "-shared", *objs, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    os.replace(tmp, os.path.join(out_dir, LIB_NAME))


def load():
    """The loaded library, built first if this source hash has no build."""
    if Built.lib is not None:
        return Built.lib
    with P.setup_span("kernels.load"):
        return _load()


def _load():
    out_dir = os.path.join(BUILD_ROOT, _digest())
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, LIB_NAME)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build per source hash across processes
        try:
            if os.path.exists(lib_path):
                P.count("kernels.loaded")
            else:
                _build(out_dir)
                for name in SOURCES:
                    P.count("kernels.built", name)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "strelka_error_string" else ctypes.c_int
    Built.lib = lib
    return lib


def ptxas_report() -> str:
    """The compiler's register/shared-memory report of the current build."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    parts = []
    for name in SOURCES:
        path = os.path.join(out_dir, name + ".log")
        if os.path.exists(path):
            with open(path, encoding="utf-8", errors="replace") as f:
                parts.append(f"== {name}\n{f.read()}")
    return "\n".join(parts)


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs)."""
    if rc != 0:
        msg = load().strelka_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device (the call
    Triton's launcher makes: torch.cuda.current_stream builds a Stream object
    first, several microseconds of host time a kernel call)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
