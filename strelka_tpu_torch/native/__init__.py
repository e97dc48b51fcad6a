"""Native (C++) host components of the port, loaded via ctypes.

The port's copy of strelka_tpu/native: the BVH builder and the USD crate
codec (LZ4 blocks and pxr integer coding). The sources are compiled on first
use with g++ into `strelka_tpu_torch/_build/native/<hash>/`, never beside the
sources: the hash covers the source, the flags and this host's CPU flags
(the build is -march=native, as the reference's, so that both packages
build the same tree on the same host). Where no toolchain is present the
entry returns None and the caller takes the numpy builder or the Python
decoder, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from strelka_tpu_torch import log

_LIB_LOCK = threading.Lock()
_LIB = None
_LIB_TRIED = False

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_ROOT = os.path.join(os.path.dirname(_SRC_DIR), "_build", "native")
_LIB_NAME = "libstrelka_native.so"
_SOURCES = ["bvh_builder.cpp", "crate_codec.cpp"]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def _lib_path() -> str:
    h = hashlib.sha256(repr(_FLAGS).encode() + _cpu_flags())
    for name in _SOURCES:
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], _LIB_NAME)


def _build_library(so_path: str) -> bool:
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, *srcs]
    try:
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native build failed to run: {}", e)
        return False
    if res.returncode != 0:
        log.warning("native build failed:\n{}", res.stderr[-2000:])
        return False
    os.replace(tmp, so_path)  # atomic: a concurrent process sees no half-written library
    return True


def get_library():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _LIB_TRIED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        try:
            so_path = _lib_path()
            if not os.path.exists(so_path) and not _build_library(so_path):
                return None
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            log.warning("native library load failed: {}", e)
            return None
        lib.strelka_lz4_decompress.restype = ctypes.c_int64
        lib.strelka_lz4_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.strelka_int_decode.restype = ctypes.c_int64
        lib.strelka_int_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.strelka_build_bvh.restype = ctypes.c_int64
        lib.strelka_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
        log.debug("native library loaded: {}", so_path)
        return _LIB


def native_build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, max_leaf: int):
    """C++ binned-SAH build. Returns (BvhNodes, perm) or None if unavailable."""
    lib = get_library()
    if lib is None:
        return None
    from strelka_tpu_torch.ops.bvh import BvhNodes

    n = int(v0.shape[0])
    if n == 0:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    cap = 2 * n
    bb_min = np.empty((cap, 3), np.float32)
    bb_max = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    start = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    perm = np.empty(n, np.int64)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lp = ctypes.POINTER(ctypes.c_int64)
    n_nodes = lib.strelka_build_bvh(
        v0.ctypes.data_as(fp),
        e1.ctypes.data_as(fp),
        e2.ctypes.data_as(fp),
        n,
        max_leaf,
        bb_min.ctypes.data_as(fp),
        bb_max.ctypes.data_as(fp),
        left.ctypes.data_as(ip),
        right.ctypes.data_as(ip),
        start.ctypes.data_as(ip),
        count.ctypes.data_as(ip),
        perm.ctypes.data_as(lp),
    )
    if n_nodes <= 0:
        return None
    nodes = BvhNodes(
        bb_min=bb_min[:n_nodes].copy(),
        bb_max=bb_max[:n_nodes].copy(),
        left=left[:n_nodes].copy(),
        right=right[:n_nodes].copy(),
        start=start[:n_nodes].copy(),
        count=count[:n_nodes].copy(),
    )
    return nodes, perm


def native_lz4_decompress(src: bytes, dst_size: int):
    """C++ LZ4 block decode -> bytes of exactly dst_size (None = unavailable,
    raises ValueError on malformed input)."""
    lib = get_library()
    if lib is None:
        return None
    dst = np.empty(max(dst_size, 1), np.uint8)
    n = lib.strelka_lz4_decompress(
        src, len(src), dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dst_size
    )
    if n < 0:
        raise ValueError("lz4: malformed block (native)")
    if n != dst_size:
        raise ValueError(f"lz4: decoded {n} bytes, expected {dst_size}")
    return dst[:dst_size].tobytes()


def native_lz4_decompress_lenient(src: bytes, dst_cap: int):
    """As native_lz4_decompress but with only an upper bound on output size."""
    lib = get_library()
    if lib is None:
        return None
    dst = np.empty(max(dst_cap, 1), np.uint8)
    n = lib.strelka_lz4_decompress(
        src, len(src), dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dst_cap
    )
    if n < 0:
        raise ValueError("lz4: malformed block (native)")
    return dst[:n].tobytes()


def native_int_decode(buf: bytes, n: int, wide: bool):
    """C++ pxr integer-compression decode -> np.int32/int64 array (None =
    native lib unavailable)."""
    lib = get_library()
    if lib is None:
        return None
    out = np.empty(n, np.int64 if wide else np.int32)
    rc = lib.strelka_int_decode(buf, len(buf), n, 1 if wide else 0, out.ctypes.data)
    if rc != 0:
        raise ValueError("integer-compression: malformed stream (native)")
    return out
