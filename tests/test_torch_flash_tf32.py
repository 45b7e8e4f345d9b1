"""The arithmetic of the flash backward kernels, checked on the CPU.

The CUDA backward kernels (``csrc/flash_attention_bwd.cu``) take every
product on the tensor cores in 3xTF32: each f32 operand x is split into
hi = tf32(x) and lo = tf32(x − hi), and a·b = hi·hi + hi·lo + lo·hi in f32
(lo·lo dropped).  With GQA the dK/dV kernel writes one f32 partial per
query head and a second kernel sums each group's partials in the order
r = 0..rep−1.  Here a plain-PyTorch emulation of those products (TF32
rounding by integer view, as the kernel rounds) runs the plain backward
at qwen2-0.5b's heads (H = 14 over Hkv = 2, D = 64, causal, f32) and is
held to ``attention_bwd_ref`` within the flash bound 2e-5·(1+max|ref|)
per gradient; one TF32 pass misses that bound, which is why the kernels
take three.  No card is needed.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as t_fa
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

H, HKV, D = 14, 2, 64           # qwen2-0.5b's attention heads


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest TF32 value, ties away from zero: the
    integer view plus half a TF32 ulp, low 13 bits cleared."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def bwd_partials(q, k, v, out, lse, dout, mm):
    """The plain causal backward with every product taken by ``mm``, in
    the kernels' order (scale folded into ds).  Returns dq (B,H,S,D) and
    the per-query-head partials dk_h, dv_h (B,H,S,D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    rep = q.shape[1] // k.shape[1]
    kh, vh = (x.repeat_interleave(rep, dim=1) for x in (k, v))
    S = q.shape[2]
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.where(mask, torch.exp(mm(q, kh.transpose(-1, -2)) * scale
                                    - lse[..., None]), 0.0)
    dp = mm(dout, vh.transpose(-1, -2))
    delta = (dout * out).sum(-1)
    ds = p * (dp - delta[..., None]) * scale
    return (mm(ds, kh), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), dout))


def group_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B,H,S,D) per-head partials to (B,Hkv,S,D): each group's partials
    added in the order r = 0..rep−1, as the group-sum kernel adds them."""
    xs = x.unflatten(1, (hkv, x.shape[1] // hkv))
    acc = xs[:, :, 0].clone()
    for r in range(1, xs.shape[2]):
        acc = acc + xs[:, :, r]
    return acc


def _inputs(S, seed, B=1):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, h, S, D)).astype(np.float32)) for h in (H, HKV, HKV, H))
    out, lse = attention_ref(q, k, v, causal=True, return_lse=True)
    return q, k, v, out, lse, do


def _ratios(got, ref):
    """max |Δ| / (2e-5·(1+max|ref|)) for each of dq, dk, dv."""
    return [float((g - r).abs().max()) / (2e-5 * (1 + float(r.abs().max())))
            for g, r in zip(got, ref)]


def _grads(S, seed, mm):
    q, k, v, out, lse, do = _inputs(S, seed)
    dq, dk_h, dv_h = bwd_partials(q, k, v, out, lse, do, mm)
    got = (dq, group_sum(dk_h, HKV), group_sum(dv_h, HKV))
    return got, attention_bwd_ref(q, k, v, out, lse, do, causal=True)


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                    # TF32's ulp at 1.0
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23,
                      -(1 + ulp / 2), 1 + 3 * ulp / 4, 3.0e-3, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + ulp,
                         float(np.float32(3.0e-3)), 0.0])
    got = tf32(x)
    assert torch.equal(got[:5], want[:5]) and got[6] == 0.0
    # a TF32 value: the low 13 mantissa bits are clear, within half an ulp
    assert int(got[5:6].view(torch.int32)) & 0x1FFF == 0
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    # hi + lo carries x to within TF32's rounding of lo
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    hi = tf32(r)
    assert float(((hi + tf32(r - hi)) - r).abs().max()
                 / r.abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("S", [128, 200])
def test_3xtf32_backward_holds_the_flash_bound(S):
    """Every product in 3xTF32, the GQA group summed from per-head
    partials: dq, dk and dv within 2e-5·(1+max|ref|) of the plain f32
    backward, with room to spare."""
    got, ref = _grads(S, S, mm_3xtf32)
    ratios = _ratios(got, ref)
    assert max(ratios) <= 0.5, ratios


def test_one_tf32_pass_misses_the_flash_bound():
    """One TF32 pass (10-bit mantissa) misses the bound on every gradient:
    the reason the kernels take three passes."""
    got, ref = _grads(128, 128, mm_1xtf32)
    ratios = _ratios(got, ref)
    assert min(ratios) > 5.0, ratios


@pytest.mark.parametrize("hkv", [2, 1, 14])
def test_group_sum_of_head_partials_is_the_group_gradient(hkv):
    """The fixed-order sum of per-head f32 partials (rep = 7, 14 and 1)
    is the plain backward's dk and dv."""
    rng = np.random.default_rng(hkv)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, h, 96, D)).astype(np.float32)) for h in (H, hkv, hkv, H))
    out, lse = attention_ref(q, k, v, causal=True, return_lse=True)
    _, dk_h, dv_h = bwd_partials(q, k, v, out, lse, do, mm_f32)
    ref = attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    got = (group_sum(dk_h, hkv), group_sum(dv_h, hkv))
    assert max(_ratios(got, ref[1:])) <= 0.1


def test_aligned_copies_only_what_the_kernels_cannot_read():
    """The backward wrapper hands the kernels' 16-byte copies only
    16-byte aligned data and strides: such a tensor goes as it is (no
    copy), any other as a contiguous copy of the same values."""
    t = torch.randn(2, 3, 5, 16)
    assert t_fa._aligned(t) is t
    view = t.transpose(1, 2)            # (B, S, H, D) read as (B, H, S, D)
    assert t_fa._aligned(view) is view
    flat = torch.randn(1 + t.numel())
    shifted = flat[1:].view(2, 3, 5, 16)  # 4 bytes past an aligned start
    odd_rows = torch.randn(2, 3, 5, 17)[..., :16]   # 68-byte rows
    for bad in (shifted, odd_rows):
        fixed = t_fa._aligned(bad)
        assert fixed is not bad and fixed.is_contiguous()
        assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, bad)


def test_group_sum_uncounted_on_the_cpu():
    """On the CPU the wrapper is the plain backward: no launch of any
    backward kernel is counted, the group sum's included."""
    q, k, v, out, lse, do = _inputs(40, 3)
    bwd = t_fa.flash_attention_bwd
    before = (bwd.launches_dq, bwd.launches_dkv, bwd.launches_group_sum)
    got = bwd(q, k, v, out, lse, do)
    for g, r in zip(got, attention_bwd_ref(q, k, v, out, lse, do)):
        assert torch.equal(g, r)
    assert (bwd.launches_dq, bwd.launches_dkv,
            bwd.launches_group_sum) == before


def test_group_sum_launch_refuses_what_it_cannot_take():
    """The group-sum launcher checks shapes, dtype, layout and device
    before it reaches the library: CPU tensors and a partials scratch of
    the wrong shape or dtype raise."""
    part = torch.zeros(2, 1, H, 40, D)
    dk = torch.zeros(1, HKV, 40, D)
    for args in ((part, dk, dk.clone()),                   # on the CPU
                 (part[:, :, :5], dk, dk.clone()),         # 5 % 2 heads
                 (part.double(), dk, dk.clone())):
        with pytest.raises(ValueError, match="group sum"):
            t_fa._group_sum_launch(*args)
