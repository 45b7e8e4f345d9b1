"""Flash attention, forward and backward: the CUDA kernels' wrappers.

The forward kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention_fwd`` of ``repro/kernels/flash_attention/flash_attention.py``:
causal (or full) attention with an online softmax, optional sliding
window, GQA through the head map ``h*Hkv//H`` and optional logit softcap,
emitting the per-row log-sum-exp.  The two backward kernels
(``csrc/flash_attention_bwd.cu``, a library of its own) replace the TPU
kernel ``flash_attention_bwd``: one computes dQ, the other dK and dV per
query head, and with GQA a third sums each group's per-head f32 partials
in a fixed order.  The forward computes in f32 on the CUDA cores, the
backward on the tensor cores in 3xTF32 (f32 accuracy); the sources'
headers say how the designs meet their bounds.

q (B,H,Sq,D) and k/v (B,Hkv,Sk,D) may be any strided views whose last
dimension is contiguous (``ops.flash_attention`` hands them transposed
views of the model's (B,S,H,D) tensors, with no copy); each output takes
its input's memory layout.  f32 or bf16 storage, f32 arithmetic.

A CPU tensor takes the plain version (``ref.attention_ref``,
``ref.attention_bwd_ref``); a CUDA tensor launches the kernel or raises.
These functions build no autograd graph, on either device: called with
an input that requires grad while grad mode is on, they raise.  The
differentiable entry point is ``ops.flash_attention``, whose
``autograd.Function`` calls them with grad mode off.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

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


def _no_graph(fn: str, *ts: torch.Tensor) -> None:
    """Refuse to be differentiated: a kernel's output carries no
    gradient, and the plain version's would on the CPU only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{fn} builds no autograd graph; differentiate "
                           f"through ops.flash_attention")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernels take beyond ``_check``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in {HEAD_DIMS}, "
                         f"got {q.shape[3]}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous last dimension")


def _strides(*ts: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(*[
        t.stride(i) for t in ts for i in (0, 1, 2)])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None,
                        logit_cap: float = 0.0, return_lse: bool = False):
    """q (B,H,Sq,D); k/v (B,Hkv,Sk,D) with H % Hkv == 0.  Returns
    (B,H,Sq,D) in q's dtype and, with ``return_lse``, the per-row
    log-sum-exp (B,H,Sq) in f32.  Query i and key j sit at positions i
    and j (self-attention over one sequence)."""
    _check(q, k, v)
    _no_graph("flash_attention_fwd", q, k, v)
    B, H, Sq, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, logit_cap=logit_cap,
                             return_lse=return_lse)
    _check_cuda(q, k, v)
    out = torch.empty_like(q)            # q's layout: (B,S,H,D) stays so
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    _fwd_launch(q, k, v, out, lse, causal, window, scale, logit_cap)
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


def _fwd_launch(q, k, v, out, lse, causal, window, scale, logit_cap) -> None:
    """One launch of the forward kernel into ``out`` (q's shape, read
    through its strides) and ``lse`` (contiguous (B,H,Sq) f32); raises on
    a non-zero CUDA code."""
    B, H, Sq, D = q.shape
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H,
                 k.shape[1], Sq, k.shape[2], _strides(q, k, v, out),
                 float(scale), float(logit_cap), int(causal), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")


flash_attention_fwd.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_launch_fns():
    lib = _build.library("flash_attention_bwd")
    common = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    tail = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                 ctypes.c_float, ctypes.c_float,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dq, dkv, gsum = lib.flash_attention_bwd_dq_launch, \
        lib.flash_attention_bwd_dkv_launch, \
        lib.flash_attention_bwd_group_sum_launch
    dq.argtypes = common + [ctypes.c_void_p] + tail
    dkv.argtypes = common + [ctypes.c_void_p] * 3 + tail
    gsum.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong),
                                ctypes.c_void_p]
    dq.restype = dkv.restype = gsum.restype = ctypes.c_int
    return dq, dkv, gsum


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the backward kernels' 16-byte copies can read it
    (data and every batch, head and row stride 16-byte aligned), else a
    contiguous copy."""
    n = t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            t.stride(i) * n % 16 == 0 or t.shape[i] == 1 for i in range(3)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bwd_launch(which: str, q, k, v, dout, lse, delta, outs, causal,
                window, scale, logit_cap, part=None) -> None:
    """One launch of the dQ (``outs`` = [dq]) or dK/dV (``outs`` = [dk,
    dv]) kernel; raises on a non-zero CUDA code.  With H > Hkv the dK/dV
    kernel writes only ``part``, a (2, B, H, Sk, D) contiguous f32 scratch
    of per-head partials, which ``_group_sum_launch`` then sums into dk
    and dv; with H == Hkv it writes dk and dv and takes no scratch."""
    _check_cuda(q, k, v)
    _no_graph(f"flash_attention_bwd_{which}", q, k, v, dout, lse, delta)
    if dout.stride(3) != 1 or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32 or not lse.is_contiguous() \
            or not delta.is_contiguous():
        raise ValueError("the backward kernels take dout with a contiguous "
                         "last dimension and contiguous f32 lse and delta")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if which == "dkv" and (part is not None) != (H > Hkv):
        raise ValueError("the dK/dV kernel takes a partials scratch exactly "
                         "when H > Hkv")
    if part is not None and (part.shape != (2, B, H, Sk, D)
                             or part.dtype != torch.float32
                             or not part.is_contiguous()
                             or part.device != q.device):
        raise ValueError(f"part must be contiguous float32 "
                         f"{(2, B, H, Sk, D)} on {q.device}")
    q, k, v, dout = (_aligned(t) for t in (q, k, v, dout))
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    fns = _bwd_launch_fns()
    strides = _strides(q, k, v, dout, *(
        [outs[0], k, v] if which == "dq" else [q, *outs]))
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta, *outs)]
    if which == "dkv":
        ptrs.append(part.data_ptr() if part is not None else None)
    with torch.cuda.device(q.device):
        err = fns[0 if which == "dq" else 1](
            _DTYPE_CODES[q.dtype], D, *ptrs, B, H, Hkv, Sq, Sk, strides,
            float(scale), float(logit_cap), int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention {which} kernel launch failed: "
                           f"CUDA error {err}")


def _group_sum_launch(part, dk, dv) -> None:
    """One launch of the group-sum kernel: dk and dv (B,Hkv,Sk,D), written
    through their strides, each the sum of its group's H/Hkv partials in
    ``part`` (2,B,H,Sk,D) f32, taken in the order r = 0..rep-1 and rounded
    once to dk's dtype; raises on a non-zero CUDA code."""
    B, Hkv, Sk, D = dk.shape
    if dv.shape != dk.shape or dv.dtype != dk.dtype \
            or part.shape[:2] != (2, B) or part.shape[3:] != (Sk, D) \
            or part.shape[2] % Hkv or part.dtype != torch.float32 \
            or not part.is_contiguous() or dk.stride(3) != 1 \
            or dv.stride(3) != 1 or dk.device.type != "cuda" \
            or not part.device == dk.device == dv.device:
        raise ValueError(f"the group sum takes (2,B,H,Sk,D) contiguous f32 "
                         f"partials and dk, dv (B,Hkv,Sk,D) with contiguous "
                         f"rows, on one card, got {tuple(part.shape)} "
                         f"{part.dtype} on {part.device}, {tuple(dk.shape)} "
                         f"on {dk.device}, {tuple(dv.shape)} on {dv.device}")
    with torch.cuda.device(dk.device):
        err = _bwd_launch_fns()[2](
            _DTYPE_CODES[dk.dtype], D, part.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, part.shape[2], Hkv, Sk, _strides(dk, dv),
            torch.cuda.current_stream(dk.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention group-sum kernel launch "
                           f"failed: CUDA error {err}")


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal=True,
                           window=0, scale=None, logit_cap=0.0):
    """The dQ kernel alone, on the card: dq in q's dtype and layout.
    ``lse`` and ``delta`` are (B,H,Sq) contiguous f32; ``dout`` has a
    contiguous last dimension.  Counted in
    ``flash_attention_bwd.launches_dq``."""
    dq = torch.empty_like(q)
    _bwd_launch("dq", q, k, v, dout, lse, delta, [dq], causal, window,
                scale, logit_cap)
    flash_attention_bwd.launches_dq += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal=True,
                            window=0, scale=None, logit_cap=0.0):
    """The dK/dV kernels alone, on the card: (dk, dv) in the dtypes and
    layouts of k and v.  With H == Hkv one launch of the dK/dV kernel;
    with H > Hkv that launch writes each query head's f32 partials to a
    scratch and a launch of the group-sum kernel sums each GQA group in a
    fixed order.  Counted in ``flash_attention_bwd.launches_dkv`` and
    ``flash_attention_bwd.launches_group_sum``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    B, H, _, D = q.shape
    part = None
    if H > k.shape[1]:
        part = torch.empty(2, B, H, k.shape[2], D, dtype=torch.float32,
                           device=q.device)
    _bwd_launch("dkv", q, k, v, dout, lse, delta, [dk, dv], causal, window,
                scale, logit_cap, part)
    flash_attention_bwd.launches_dkv += 1
    if part is not None:
        _group_sum_launch(part, dk, dv)
        flash_attention_bwd.launches_group_sum += 1
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None,
                        logit_cap: float = 0.0):
    """The flash VJP.  q/out/dout (B,H,Sq,D); k/v (B,Hkv,Sk,D); lse
    (B,H,Sq) f32 from the forward.  Returns (dq, dk, dv) in the dtypes and
    memory layouts of q, k and v: on the card one launch of the dQ kernel
    and one of the dK/dV kernel, counted in ``launches_dq`` and
    ``launches_dkv``, and with H > Hkv one of the group-sum kernel,
    counted in ``launches_group_sum``.

    δ = rowsum(dO·O) is one plain f32 reduction here, as the reference
    takes it outside its kernels.  ``dout`` may come from autograd with
    any strides (even a zero stride from an ``expand``): one whose last
    dimension is not contiguous is copied to a contiguous tensor first;
    any other is read in place through its strides."""
    _check(q, k, v)
    _no_graph("flash_attention_bwd", q, k, v, out, lse, dout)
    B, H, Sq, D = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, H, Sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    kw = dict(causal=causal, window=window, logit_cap=logit_cap,
              scale=scale if scale is not None else 1.0 / math.sqrt(D))
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    # (B,H,Sq) f32; a reduction over strided inputs may keep their
    # layout, so it is made contiguous for the kernels
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    lse = lse.contiguous()
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0
flash_attention_bwd.launches_group_sum = 0
