"""Mamba2 SSD chunk scan: the CUDA kernel's wrapper.

The kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel ``ssd_scan_fwd``
of ``repro/kernels/ssd_scan/ssd_scan.py``: per (batch, head) it walks the
chunks in order with the (P, N) state on chip and returns y and the final
state, both in f32.  It is bound by f32 arithmetic on the CUDA cores; the
source's header says how the design meets that.

x (Bt,L,H,P) and B/C (Bt,L,G,N) may be any strided views whose last
dimension is contiguous (the model hands over views of its conv output,
with no copy), in f32 or bf16 (one dtype for the three); dt (Bt,L,H) is
f32 with any strides and A (H,) f32.  L must be a multiple of ``chunk``,
G must divide H, and (chunk, P, N) must be one the kernel is built for
(``CHUNKS``, ``HEAD_DIMS``, ``STATE_DIMS``); the wrapper raises otherwise,
on either device.

A CPU tensor takes the plain version (``ref.ssd_chunked``); a CUDA tensor
launches the kernel or raises.  This function builds no autograd graph:
called with an input that requires grad while grad mode is on, it
raises.  The differentiable entry point is ``ops.ssd``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's instantiations: every (chunk, P, N) of the port's configs
# and of the reference's SSD_CASES
CHUNKS = (16, 32, 64, 128)
HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = _build.library("ssd_scan").ssd_scan_fwd_launch
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"x must be (Bt,L,H,P) and B, C (Bt,L,G,N), got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    Bt, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if dt.shape != (Bt, L, H) or A.shape != (H,) \
            or B.shape[:2] != (Bt, L) or G == 0 or H % G:
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)} and "
                         f"B/C {tuple(B.shape)} do not fit x "
                         f"{tuple(x.shape)} (G must divide H)")
    if x.dtype not in _DTYPE_CODES or B.dtype != x.dtype \
            or C.dtype != x.dtype or dt.dtype != torch.float32 \
            or A.dtype != torch.float32:
        raise TypeError(f"the SSD scan takes float32 or bfloat16 x, B, C of "
                        f"one dtype and float32 dt and A, got {x.dtype}, "
                        f"{B.dtype}, {C.dtype}, {dt.dtype}, {A.dtype}")
    if chunk <= 0 or L % chunk:
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    if chunk not in CHUNKS or P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"the SSD kernel is built for chunk in {CHUNKS}, "
                         f"P in {HEAD_DIMS} and N in {STATE_DIMS}, got "
                         f"chunk={chunk}, P={P}, N={N}")
    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError("x, dt, A, B and C must be on one device")


def _no_graph(*ts: torch.Tensor) -> None:
    """Refuse to be differentiated: the kernel's output carries no
    gradient, and the plain version's would on the CPU only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("ssd_scan_fwd builds no autograd graph; "
                           "differentiate through ops.ssd")


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (Bt,L,H,P) f32, final_state (Bt,H,P,N) f32); on the
    card one launch, counted in ``ssd_scan_fwd.launches``."""
    _check(x, dt, A, B, C, chunk)
    _no_graph(x, dt, A, B, C)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"the SSD scan runs on cuda or cpu, not {x.device}")
    Bt, L, H, P = x.shape
    y = torch.empty(Bt, L, H, P, dtype=torch.float32, device=x.device)
    state = torch.empty(Bt, H, P, B.shape[3], dtype=torch.float32,
                        device=x.device)
    _launch(x, dt, A, B, C, y, state, chunk)
    ssd_scan_fwd.launches += 1
    return y, state


def _launch(x, dt, A, B, C, y, state, chunk: int) -> None:
    """One launch of the kernel into ``y`` ((Bt,L,H,P) f32, read through
    its strides) and ``state`` (contiguous (Bt,H,P,N) f32); raises on a
    layout the kernel does not take and on a non-zero CUDA code."""
    if any(t.stride(3) != 1 for t in (x, B, C, y)) \
            or not A.is_contiguous() or not state.is_contiguous():
        raise ValueError("x, B, C and y need a contiguous last dimension, "
                         "A and the state contiguous")
    Bt, L, H, P = x.shape
    strides = (ctypes.c_longlong * 15)(*[
        t.stride(i) for t in (x, dt, B, C, y) for i in (0, 1, 2)])
    with torch.cuda.device(x.device):
        err = _launch_fn()(
            _DTYPE_CODES[x.dtype], P, B.shape[3], chunk,
            *[t.data_ptr() for t in (x, dt, A, B, C, y, state)],
            Bt, L, H, B.shape[2], strides,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSD scan kernel launch failed: CUDA error {err}")


ssd_scan_fwd.launches = 0
