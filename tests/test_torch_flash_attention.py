"""The port's flash-attention forward against the reference's.

On the CPU the port's wrapper takes its plain version
(``ref.attention_ref``); the reference runs its Pallas kernel in
interpret mode.  Same inputs (numpy from one seed) on both sides, over
the reference's own ``FA_CASES``, at the reference's tolerances: f32
2e-5, bf16 2e-2 (the output is rounded to bf16).  The log-sum-exp is
f32 on both sides: 2e-5·(1+max|lse|).  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_fa
from repro.kernels.flash_attention import ops as j_ops
from repro.kernels.flash_attention import ref as j_ref
from repro_torch.kernels.flash_attention import flash_attention as t_fa
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention import ref as t_ref

torch.set_num_threads(2)

FA_CASES = [
    # B, H, Hkv, S, D, window, cap, dtype (tests/test_kernels.py)
    (2, 4, 4, 128, 64, 0, 0.0, "float32"),
    (1, 8, 2, 256, 64, 0, 0.0, "float32"),      # GQA 4:1
    (2, 4, 2, 200, 32, 64, 0.0, "float32"),     # ragged + window
    (1, 4, 4, 128, 64, 0, 50.0, "float32"),     # softcap (gemma2)
    (1, 2, 1, 512, 128, 128, 0.0, "float32"),   # MQA + window
    (1, 4, 2, 256, 64, 0, 0.0, "bfloat16"),     # bf16 storage
    (1, 3, 1, 96, 16, 32, 30.0, "float32"),     # odd heads, all features
]


def _inputs(B, H, Hkv, S, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for h in (H, Hkv, Hkv)]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


@pytest.mark.parametrize("B,H,Hkv,S,D,win,cap,dtype", FA_CASES)
def test_model_layout_matches_reference_kernel(B, H, Hkv, S, D, win, cap,
                                               dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, H, Hkv, S, D, dtype, S + D)
    ref = j_ops.flash_attention(jq, jk, jv, causal=True, window=win,
                                logit_cap=cap, block_q=64, block_k=64,
                                interpret=True)
    out = t_ops.flash_attention(tq, tk, tv, causal=True, window=win,
                                logit_cap=cap)
    assert out.shape == (B, S, H, D) and out.dtype == tq.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol)


@pytest.mark.parametrize("B,H,Hkv,S,D,win,cap,dtype", FA_CASES)
def test_fwd_and_lse_match_reference(B, H, Hkv, S, D, win, cap, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, H, Hkv, S, D, dtype, S * D)
    jt = [x.transpose(0, 2, 1, 3) for x in (jq, jk, jv)]
    tt = [x.transpose(1, 2) for x in (tq, tk, tv)]
    ref, ref_lse = j_fa.flash_attention_fwd(
        *jt, causal=True, window=win, logit_cap=cap, block_q=64,
        block_k=64, interpret=True, return_lse=True)
    out, lse = t_fa.flash_attention_fwd(*tt, causal=True, window=win,
                                        logit_cap=cap, return_lse=True)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    ref_lse = np.asarray(ref_lse)
    np.testing.assert_allclose(lse.numpy(), ref_lse,
                               atol=2e-5 * (1 + np.abs(ref_lse).max()))
    # the plain version alone against the reference's oracle
    plain = t_ref.attention_ref(*tt, causal=True, window=win, logit_cap=cap)
    oracle = j_ref.attention_ref(*jt, causal=True, window=win,
                                 logit_cap=cap)
    np.testing.assert_allclose(_f32(plain), _f32(oracle), atol=tol)


def test_requires_grad_raises():
    """The kernels' wrappers build no graph: called directly with an input
    that requires grad, in grad mode, each raises and names the
    differentiable entry point, on the CPU as on the card.  Through
    ``ops.flash_attention`` the same input is differentiated (the
    backward raises on a cotangent that does not fit the output), and
    without grad mode the wrappers run."""
    _, (q, k, v) = _inputs(1, 2, 1, 16, 16, "float32", 0)
    q.requires_grad_(True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    with pytest.raises(RuntimeError, match="ops.flash_attention"):
        t_fa.flash_attention_fwd(qt, kt, vt)
    with torch.no_grad():
        o, lse = t_fa.flash_attention_fwd(qt, kt, vt, return_lse=True)
    with pytest.raises(RuntimeError, match="ops.flash_attention"):
        t_fa.flash_attention_bwd(qt, kt, vt, o, lse, o)
    out = t_ops.flash_attention(q, k, v)
    assert out.grad_fn is not None
    (dq,) = torch.autograd.grad(out.sum(), q)
    assert dq.shape == q.shape and bool(torch.isfinite(dq).all())
    qt = qt.detach()
    with pytest.raises(ValueError, match="dout"):
        t_fa.flash_attention_bwd(qt, kt, vt, o, lse, o[:, :1])
    with torch.inference_mode():
        out = t_ops.flash_attention(q.detach(), k, v)
    assert out.shape == q.shape


def test_rejects_bad_inputs():
    _, (q, k, v) = _inputs(1, 4, 3, 16, 16, "float32", 1)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        t_fa.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2))
    _, (q, k, v) = _inputs(1, 2, 1, 16, 16, "float32", 2)
    with pytest.raises(TypeError):
        t_ops.flash_attention(q.double(), k.double(), v.double())
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_ops.flash_attention(*meta)
