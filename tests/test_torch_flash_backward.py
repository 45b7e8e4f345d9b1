"""The port's flash-attention backward against the reference's.

The reference's gradients are ``jax.grad`` of its ``ops.flash_attention``
(the ``custom_vjp`` over its Pallas forward and its two Pallas backward
kernels, run in interpret mode).  On the port's side two paths are held
to them on the CPU: the plain backward ``ref.attention_bwd_ref`` fed the
port's own forward (out, lse), and autograd through ``ops.flash_attention``
(the ``torch.autograd.Function`` whose CPU path takes the plain versions).
Same inputs and cotangent (numpy from one seed) on both sides, over the
reference's backward cases, the reference's ``FA_CASES`` and qwen2-0.5b's
attention (14 heads over 2 kv heads, head_dim 64).  Tolerances: f32
2e-5·(1+max|ref|), the forward's bound; bf16 one bf16 ulp of
max(|out|, |ref|) on top of it, elementwise (both sides compute in f32
and round the gradient once).  The CUDA kernels are held against the
plain backward on the card (``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops
from repro_torch.kernels.flash_attention import flash_attention as t_fa
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention import ref as t_ref

torch.set_num_threads(2)

BWD_CASES = [
    # B, H, Hkv, S, D, window, cap, dtype
    # the reference's backward cases (tests/test_kernels.py)
    (1, 4, 2, 128, 32, 0, 0.0, "float32"),
    (1, 4, 2, 160, 32, 48, 0.0, "float32"),
    (1, 2, 1, 96, 16, 0, 30.0, "float32"),
    # FA_CASES (tests/test_torch_flash_attention.py)
    (2, 4, 4, 128, 64, 0, 0.0, "float32"),
    (1, 8, 2, 256, 64, 0, 0.0, "float32"),
    (2, 4, 2, 200, 32, 64, 0.0, "float32"),
    (1, 4, 4, 128, 64, 0, 50.0, "float32"),
    (1, 2, 1, 512, 128, 128, 0.0, "float32"),
    (1, 4, 2, 256, 64, 0, 0.0, "bfloat16"),
    (1, 3, 1, 96, 16, 32, 30.0, "float32"),
    # qwen2-0.5b's heads at a tile multiple and ragged
    (1, 14, 2, 128, 64, 0, 0.0, "float32"),
    (1, 14, 2, 200, 64, 0, 0.0, "float32"),
]


def _inputs(B, H, Hkv, S, D, dtype, seed):
    """q, k, v and the cotangent (model layout) as jax and torch arrays."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for h in (H, Hkv, Hkv, H)]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _reference_grads(jq, jk, jv, jct, win, cap):
    def f(q, k, v):
        out = j_ops.flash_attention(q, k, v, causal=True, window=win,
                                    logit_cap=cap, block_q=64, block_k=64,
                                    interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jct.astype(jnp.float32))
    return jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)


def _assert_close(out, ref, dtype, name):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    out = np.asarray(out, np.float32)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float32)
    assert out.shape == ref.shape, name
    diff = np.abs(out - ref)
    tol = 2e-5 * (1.0 + float(np.abs(ref).max()))
    if dtype == "bfloat16":
        mag = np.maximum(np.abs(out), np.abs(ref))
        _, e = np.frexp(np.maximum(mag, 2.0 ** -126))
        tol = np.ldexp(1.0, e - 8) + tol     # one bf16 ulp on top
    bad = diff > tol
    assert not bad.any(), (f"{name}: max |Δ| {diff.max():.3e}, "
                           f"{int(bad.sum())} elements over the bound")


@pytest.mark.parametrize("B,H,Hkv,S,D,win,cap,dtype", BWD_CASES)
def test_plain_backward_matches_reference(B, H, Hkv, S, D, win, cap, dtype):
    (jq, jk, jv, jct), (tq, tk, tv, tct) = _inputs(B, H, Hkv, S, D, dtype,
                                                   S + 7 * H + D)
    ref = _reference_grads(jq, jk, jv, jct, win, cap)
    qt, kt, vt, ct = (x.transpose(1, 2) for x in (tq, tk, tv, tct))
    kw = dict(causal=True, window=win, logit_cap=cap)
    out, lse = t_ref.attention_ref(qt, kt, vt, return_lse=True, **kw)
    grads = t_ref.attention_bwd_ref(qt, kt, vt, out, lse, ct, **kw)
    for g, r, name in zip(grads, ref, ("dq", "dk", "dv")):
        assert g.dtype == tq.dtype
        _assert_close(g.transpose(1, 2), r, dtype, name)


@pytest.mark.parametrize("B,H,Hkv,S,D,win,cap,dtype", BWD_CASES)
def test_autograd_through_ops_matches_reference(B, H, Hkv, S, D, win, cap,
                                                dtype):
    (jq, jk, jv, jct), (tq, tk, tv, tct) = _inputs(B, H, Hkv, S, D, dtype,
                                                   S * H + D)
    ref = _reference_grads(jq, jk, jv, jct, win, cap)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = t_ops.flash_attention(*leaves, causal=True, window=win,
                                logit_cap=cap)
    assert out.shape == (B, S, H, D) and out.dtype == tq.dtype
    (out.float() * tct.float()).sum().backward()
    for x, r, name in zip(leaves, ref, ("dq", "dk", "dv")):
        assert x.grad.dtype == tq.dtype
        _assert_close(x.grad, r, dtype, name)


def test_wrapper_on_cpu_is_the_plain_backward():
    """A CPU tensor takes the plain backward (no launch counted); the
    wrapper checks what it is given."""
    _, (tq, tk, tv, tct) = _inputs(2, 4, 2, 40, 16, "float32", 5)
    qt, kt, vt, ct = (x.transpose(1, 2) for x in (tq, tk, tv, tct))
    out, lse = t_fa.flash_attention_fwd(qt, kt, vt, window=8,
                                        return_lse=True)
    before = (t_fa.flash_attention_bwd.launches_dq,
              t_fa.flash_attention_bwd.launches_dkv)
    got = t_fa.flash_attention_bwd(qt, kt, vt, out, lse, ct, window=8)
    want = t_ref.attention_bwd_ref(qt, kt, vt, out, lse, ct, window=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (t_fa.flash_attention_bwd.launches_dq,
            t_fa.flash_attention_bwd.launches_dkv) == before
    with pytest.raises(ValueError, match="lse"):
        t_fa.flash_attention_bwd(qt, kt, vt, out, lse[:, :, :-1], ct)
    with pytest.raises(ValueError, match="dout"):
        t_fa.flash_attention_bwd(qt, kt, vt, out, lse, ct[:, :, :-1])


def test_zero_stride_cotangent():
    """The gradient autograd hands the backward may be an expand (zero
    strides); the result equals that of a dense cotangent."""
    _, (tq, tk, tv, _) = _inputs(1, 4, 2, 64, 32, "float32", 6)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    t_ops.flash_attention(*leaves).sum().backward()    # grad is expand(1)
    dense = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = t_ops.flash_attention(*dense)
    out.backward(torch.ones_like(out))
    for a, b in zip(leaves, dense):
        assert torch.equal(a.grad, b.grad)


def test_model_layout_reaches_the_backward_without_copies(monkeypatch):
    """Through ``attention_forward(impl="pallas")`` the kernels get the
    projections' (B, S, H, D) memory as transposed views, and the
    cotangent autograd hands the backward has a contiguous last dimension,
    so the card path copies nothing."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as t_attn
    from repro_torch.models import layers as t_layers

    cfg = get_config("qwen2-0.5b").reduced()
    seen = {}
    real = t_fa.flash_attention_bwd

    def spy(q, k, v, out, lse, dout, **kw):
        seen["views"] = [x.transpose(1, 2).is_contiguous()
                         for x in (q, k, v)]
        seen["dout_stride3"] = dout.stride(3)
        return real(q, k, v, out, lse, dout, **kw)

    monkeypatch.setattr(t_ops, "flash_attention_bwd", spy)
    gen = torch.Generator().manual_seed(0)
    params = t_attn.attention_init(gen, cfg)
    x = torch.randn(2, 24, cfg.d_model, generator=gen, requires_grad=True)
    out = t_attn.attention_forward(params, t_layers.rmsnorm(
        {"scale": torch.zeros(cfg.d_model)}, x), cfg, window=0,
        impl="pallas")
    out.sum().backward()
    assert seen == {"views": [True] * 3, "dout_stride3": 1}
    assert bool(torch.isfinite(x.grad).all())
