"""Flash-attention forward: the CUDA kernel's wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention_fwd`` of ``repro/kernels/flash_attention/flash_attention.py``:
causal (or full) attention with an online softmax, optional sliding
window, GQA through the head map ``h*Hkv//H`` and optional logit softcap,
emitting the per-row log-sum-exp.  It is bound by f32 arithmetic on the
CUDA cores; the source's header says how the design meets that.

q (B,H,Sq,D) and k/v (B,Hkv,Sk,D) may be any strided views whose last
dimension is contiguous (``ops.flash_attention`` hands it transposed
views of the model's (B,S,H,D) tensors, with no copy); the output takes
q's memory layout.  f32 or bf16 storage, f32 arithmetic.

A CPU tensor takes the plain version (``ref.attention_ref``); a CUDA
tensor launches the kernel or raises.  Forward only: an input that
requires grad raises until the backward kernel is ported.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)      # the kernel's instantiations


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = _build.library("flash_attention").flash_attention_fwd_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention_fwd is forward only: the backward kernel "
            "comes with the training slice (ROADMAP Queue 2 #4)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,H,Sq,D) and k, v (B,Hkv,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] == 0 \
            or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of Hkv)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None,
                        logit_cap: float = 0.0, return_lse: bool = False):
    """q (B,H,Sq,D); k/v (B,Hkv,Sk,D) with H % Hkv == 0.  Returns
    (B,H,Sq,D) in q's dtype and, with ``return_lse``, the per-row
    log-sum-exp (B,H,Sq) in f32.  Query i and key j sit at positions i
    and j (self-attention over one sequence)."""
    _check(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, logit_cap=logit_cap,
                             return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous last dimension")
    out = torch.empty_like(q)            # q's layout: (B,S,H,D) stays so
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)])
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, Hkv,
                 Sq, Sk, strides, float(scale), float(logit_cap),
                 int(causal), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0
