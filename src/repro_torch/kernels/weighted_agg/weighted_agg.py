"""Weighted aggregation over a flat parameter buffer: the CUDA kernel's
wrapper.

    out = c0 · g + Σ_c coef_c · rows[r(c)]      r(c) = cids[c] or c

With one row and coefs [β, 1−β] this is the paper's eq. (3); with the
whole (M, n) fleet buffer it is the FedAvg round, eq. (2).  The kernel
(``csrc/weighted_agg.cu``) replaces the TPU kernels ``weighted_agg_flat2d``
and ``weighted_agg_flat`` of ``repro/kernels/weighted_agg/weighted_agg.py``;
the two TPU layouts are one kernel here, exposed under both names.  It
is bounded by device-memory bytes; the source's header says how the
design meets that bound.

Rows come as a (R, n) tensor whose rows are contiguous but may sit at
any row stride (a view of a padded fleet buffer), plus optional int32
``cids`` that pick C of the R rows inside the kernel; without ``cids``
all R rows are used.  Coefficients are a device f32 tensor of C+1
values, so a blend needs no host sync.

A CPU tensor takes the plain version (``ref.weighted_agg_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.weighted_agg.ref import weighted_agg_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = _build.library("weighted_agg").weighted_agg_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def vectorizable(g: torch.Tensor, rows: torch.Tensor,
                 out: torch.Tensor) -> bool:
    """True when every access can be a 16-byte vector: g, out and the
    rows' base are 16-byte aligned and so is the row stride in bytes
    (a single row has no stride to honour)."""
    stride_ok = (rows.shape[0] <= 1
                 or rows.stride(0) * rows.element_size() % _VEC_BYTES == 0)
    return stride_ok and all(t.data_ptr() % _VEC_BYTES == 0
                             for t in (g, rows, out))


def _check(g, rows, coefs, cids) -> int:
    """Validate what the kernel takes; returns C."""
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"weighted_agg takes float32 or bfloat16, "
                        f"got {g.dtype}")
    if g.dim() != 1 or not g.is_contiguous():
        raise ValueError("g must be a contiguous (n,) tensor")
    n = g.shape[0]
    if rows.dim() != 2 or rows.shape[1] != n:
        raise ValueError(f"rows must be (R, {n}), got {tuple(rows.shape)}")
    if rows.dtype != g.dtype:
        raise TypeError(f"rows dtype {rows.dtype} != g dtype {g.dtype}")
    if n > 1 and rows.shape[0] > 0 and rows.stride(1) != 1:
        raise ValueError("each row must be contiguous (rows.stride(1) == 1)")
    for name, t in (("rows", rows), ("coefs", coefs), ("cids", cids)):
        if t is not None and t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, g on {g.device}")
    if cids is None:
        C = rows.shape[0]
    else:
        if cids.dtype != torch.int32 or cids.dim() != 1 \
                or not cids.is_contiguous():
            raise TypeError("cids must be a contiguous int32 (C,) tensor")
        C = cids.shape[0]
    if coefs.dtype != torch.float32 or coefs.dim() != 1 \
            or not coefs.is_contiguous() or coefs.shape[0] != C + 1:
        raise ValueError(f"coefs must be a contiguous float32 ({C + 1},) "
                         f"tensor, got {coefs.dtype} {tuple(coefs.shape)}")
    return C


def weighted_agg_flat2d(g: torch.Tensor, rows: torch.Tensor,
                        coefs: torch.Tensor,
                        cids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """out = coefs[0]·g + Σ_c coefs[c+1]·rows[r(c)] as a new (n,) tensor
    in g's dtype (f32 accumulation).  ``cids`` must lie in
    [0, rows.shape[0]); the kernel traps on one that does not."""
    C = _check(g, rows, coefs, cids)
    if g.device.type == "cpu":
        return weighted_agg_ref(g, rows, coefs, cids)
    if g.device.type != "cuda":
        raise ValueError(f"weighted_agg runs on cuda or cpu, not {g.device}")
    out = torch.empty_like(g)
    if g.shape[0] == 0:
        return out
    _launch(g, rows, coefs, cids, C, out)
    weighted_agg_flat2d.launches += 1
    return out


def _launch(g, rows, coefs, cids, C: int, out: torch.Tensor) -> None:
    """One launch of the kernel into ``out`` (n,); raises on a non-zero
    CUDA code."""
    fn = _launch_fn()
    with torch.cuda.device(g.device):
        err = fn(_DTYPE_CODES[g.dtype], g.data_ptr(), rows.data_ptr(),
                 rows.stride(0), rows.shape[0],
                 None if cids is None else cids.data_ptr(), C,
                 coefs.data_ptr(), out.data_ptr(), g.shape[0],
                 int(vectorizable(g, rows, out)),
                 torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"weighted_agg kernel launch failed: CUDA error "
                           f"{err}")


weighted_agg_flat2d.launches = 0

# The TPU's 1-D layout (``weighted_agg_flat``) is the same function; on
# the card both layouts are this one kernel.
weighted_agg_flat = weighted_agg_flat2d
