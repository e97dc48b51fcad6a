"""What every lane kernel's wrapper shares: K10 (kernels/shade.py), K11 and
K12 (kernels/nee.py) and K13 (kernels/surface.py).

A lane kernel runs one thread a lane over [N] arrays, one array a field. Its
C entry (strelka_<kernel>) takes two host arrays of device pointers, its
inputs' and its outputs', each in the order of an enum of its CUDA source,
then the kernel's scalars and the stream. A wrapper names its fields in that
order and their dtypes (f32 unless named), checks its inputs and tables here
before either its kernel or its plain version runs, and launches here.

K10 and K12 have one kernel instance per fibre variant, the hair lobes the
plain code takes (fibre_variant).
"""

from __future__ import annotations

import ctypes

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import build
from strelka_tpu_torch.ops import bsdf as B

NO_FIBRE, CHIANG, KAJIYA_KAY = 0, 1, 2  # csrc/bsdf.cuh: kNoFibre, kChiang, kKajiyaKay


def fibre_variant(enable_hair: bool) -> int:
    """The kernel instance the plain code's choice of hair lobes asks for:
    none without hair, else ops/bsdf.py's, read at the call (the Kajiya-Kay
    lobes where _HAIR_KAJIYA_KAY is set, by STRELKA_HAIR_KK=1 at import)."""
    if not enable_hair:
        return NO_FIBRE
    return KAJIYA_KAY if B._HAIR_KAJIYA_KAY else CHIANG


def checked(kernel: str, fields, ts: list, dtypes: dict, like: str) -> list:
    """A lane kernel's inputs `ts` in the order of `fields`, each checked: a
    contiguous [N] tensor of its dtype (f32 unless `dtypes` names it) on the
    device of the input named `like`, whose length is N."""
    ref = ts[fields.index(like)]
    n, dev = ref.shape[0], ref.device
    for name, t in zip(fields, ts):
        want = dtypes.get(name, torch.float32)
        if not isinstance(t, torch.Tensor) or t.dtype != want or t.shape != (n,) or not t.is_contiguous():
            what = (f"{t.dtype} {tuple(t.shape)}{'' if t.is_contiguous() else ' non-contiguous'}"
                    if isinstance(t, torch.Tensor) else type(t).__name__)
            raise ValueError(f"{kernel}: {name} must be a contiguous [{n}] {want} tensor, not {what}")
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, {like} on {dev}")
    return ts


def table(kernel: str, name: str, t, shape: tuple, dtype, dev) -> None:
    """Check a table a lane kernel reads whole: a contiguous non-empty tensor
    of `dtype` and `shape` (None: any number of rows) on the lanes' device."""
    ok = (isinstance(t, torch.Tensor) and t.dtype == dtype and t.dim() == len(shape) and t.is_contiguous()
          and all(want is None or got == want for got, want in zip(t.shape, shape)) and t.numel() > 0)
    if not ok:
        dims = ", ".join("rows >= 1" if s is None else str(s) for s in shape)
        raise ValueError(f"{kernel}: {name} must be a contiguous non-empty [{dims}] {dtype} tensor")
    if t.device != dev:
        raise ValueError(f"{kernel}: {name} is on {t.device}, the lanes on {dev}")


def outputs(fields, dtypes: dict, n: int, dev) -> dict:
    """A lane kernel's outputs by name, allocated on the current stream: one
    [k, n] block a dtype (f32 unless `dtypes` names it), a row an output."""
    rows = {}
    for dtype in (torch.float32, torch.int32, torch.bool):
        names = [f for f in fields if dtypes.get(f, torch.float32) == dtype]
        if names:
            rows.update(zip(names, torch.empty((len(names), n), dtype=dtype, device=dev)))
    return rows


def pointers(ts: list):
    """A host array of the tensors' device pointers (NULL for None)."""
    return (ctypes.c_void_p * len(ts))(*(None if t is None else t.data_ptr() for t in ts))


def launch(kernel: str, ins: list, out_fields, dtypes: dict, *args, shape: tuple, absent=()) -> dict:
    """Launch a lane kernel on CUDA tensors -> its outputs by name.

    Allocates the outputs of `out_fields` but those in `absent` (outputs),
    and calls the C entry strelka_<kernel> with host arrays of the inputs'
    and outputs' device pointers (NULL for None and for an absent output: a
    field the kernel instance does not read or write), `args` and the
    current stream, unless there are no lanes. `shape` is the launch's key in
    K.launch_shapes, its lane count first."""
    dev = ins[0].device
    K.require_cuda(ins[0], kernel)
    n = shape[0]
    o = outputs([f for f in out_fields if f not in absent], dtypes, n, dev)
    if n > 0:
        rc = getattr(build.load(), "strelka_" + kernel)(pointers(ins), pointers([o.get(f) for f in out_fields]),
                                                        *args, build.stream_ptr(dev))
        build.check(rc, kernel)
        K.count_launch(kernel, shape)
    return o
