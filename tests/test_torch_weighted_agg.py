"""The weighted-aggregation kernel's plain version against the TPU
kernel, and the CUDA kernel against its plain version.

On the CPU the reference's Pallas kernels run in interpret mode
(``weighted_agg_flat2d`` with one whole-buffer block, and the 1-D
``weighted_agg_flat``).  Tolerances: f32 1e-6·(1+max|ref|) — summation
order and FMA only; bf16 one bf16 ulp on top of that f32 bound — both
accumulate in f32 and round once.  The CUDA kernel itself is held against the plain version on the
card in tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.weighted_agg.weighted_agg import (
    weighted_agg_flat as j_agg_flat, weighted_agg_flat2d as j_agg_flat2d)
from repro_torch.kernels.weighted_agg import weighted_agg as wa
from repro_torch.kernels.weighted_agg.ref import weighted_agg_ref

torch.set_num_threads(2)


def _inputs(C, n, R=None, seed=0):
    rng = np.random.default_rng(seed + 31 * C + n)
    R = C if R is None else R
    g = rng.normal(size=n).astype(np.float32)
    rows = rng.normal(size=(R, n)).astype(np.float32)
    coefs = rng.uniform(-1.0, 1.0, C + 1).astype(np.float32)
    return g, rows, coefs


def _bf16_round(x):
    """f32 values exactly representable in bf16 (both sides start equal)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _torch(x, dtype):
    return torch.from_numpy(np.array(x)).to(dtype)


def _bf16_ulp(x):
    ax = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(ax)) - 7)


def assert_agg_close(out, ref, dtype):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    tol = 1e-6 * (1.0 + float(np.max(np.abs(ref), initial=0.0)))
    if dtype == "bfloat16":
        # one ulp from the final rounding, on top of the f32 bound: where
        # cancellation leaves a result below the f32 accumulation error,
        # FMA and mul-add differ by more than that tiny result's ulp
        tol = tol + _bf16_ulp(np.maximum(np.abs(out), np.abs(ref)))
        assert np.all(np.abs(out - ref) <= tol)
    else:
        assert float(np.max(np.abs(out - ref), initial=0.0)) <= tol


CASES = [(C, n, dt) for dt in ("float32", "bfloat16")
         for C, n in ((1, 1), (1, 4099), (3, 1000), (8, 4099), (8, 128))]


@pytest.mark.parametrize("C,n,dtype", CASES)
def test_ref_matches_pallas_flat2d(C, n, dtype):
    g, rows, coefs = _inputs(C, n)
    if dtype == "bfloat16":
        g, rows = _bf16_round(g), _bf16_round(rows)
    tdt = getattr(torch, dtype)
    out = weighted_agg_ref(_torch(g, tdt), _torch(rows, tdt),
                           torch.from_numpy(coefs))
    ref = j_agg_flat2d(jnp.asarray(g, dtype), jnp.asarray(rows, dtype),
                       jnp.asarray(coefs), interpret=True, block_rows=None)
    assert out.dtype == tdt
    assert_agg_close(out.float(), ref, dtype)


@pytest.mark.parametrize("C,n,dtype", [(1, 300, "float32"), (3, 1000,
                                       "float32"), (8, 777, "bfloat16")])
def test_ref_matches_pallas_flat_1d(C, n, dtype):
    g, rows, coefs = _inputs(C, n, seed=5)
    if dtype == "bfloat16":
        g, rows = _bf16_round(g), _bf16_round(rows)
    tdt = getattr(torch, dtype)
    out = weighted_agg_ref(_torch(g, tdt), _torch(rows, tdt),
                           torch.from_numpy(coefs))
    ref = j_agg_flat(jnp.asarray(g, dtype), jnp.asarray(rows, dtype),
                     jnp.asarray(coefs), block_elems=256, interpret=True)
    assert_agg_close(out.float(), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cids", [[2], [4, 0, 2], [1, 1, 3, 0, 5, 2, 2, 4]])
def test_ref_gather_matches_pallas_take(dtype, cids):
    """The cids form == the reference's jnp.take then the kernel."""
    C, n, R = len(cids), 1031, 6
    g, rows, coefs = _inputs(C, n, R=R, seed=9)
    if dtype == "bfloat16":
        g, rows = _bf16_round(g), _bf16_round(rows)
    tdt = getattr(torch, dtype)
    out = weighted_agg_ref(_torch(g, tdt), _torch(rows, tdt),
                           torch.from_numpy(coefs),
                           torch.tensor(cids, dtype=torch.int32))
    ref = j_agg_flat2d(jnp.asarray(g, dtype),
                       jnp.take(jnp.asarray(rows, dtype),
                                jnp.asarray(cids), axis=0),
                       jnp.asarray(coefs), interpret=True, block_rows=None)
    assert_agg_close(out.float(), ref, dtype)


@pytest.mark.parametrize("fn", [wa.weighted_agg_flat2d, wa.weighted_agg_flat])
def test_wrapper_on_cpu_is_the_plain_version(fn):
    g, rows, coefs = _inputs(4, 513)
    before = wa.weighted_agg_flat2d.launches
    args = (torch.from_numpy(g), torch.from_numpy(rows),
            torch.from_numpy(coefs))
    assert torch.equal(fn(*args), weighted_agg_ref(*args))
    cids = torch.tensor([3, 0], dtype=torch.int32)
    args = (args[0], args[1], args[2][:3].contiguous())
    assert torch.equal(fn(*args, cids), weighted_agg_ref(*args, cids))
    # the count is of kernel launches only
    assert wa.weighted_agg_flat2d.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g = torch.zeros(16)
    rows = torch.zeros(2, 16)
    coefs = torch.zeros(3)
    with pytest.raises(TypeError):
        wa.weighted_agg_flat2d(g.double(), rows.double(), coefs)
    with pytest.raises(TypeError):
        wa.weighted_agg_flat2d(g, rows.bfloat16(), coefs)
    with pytest.raises(ValueError):
        wa.weighted_agg_flat2d(g, torch.zeros(2, 15), coefs)
    with pytest.raises(ValueError):
        wa.weighted_agg_flat2d(g, rows, torch.zeros(2))
    with pytest.raises(ValueError):
        wa.weighted_agg_flat2d(g, torch.zeros(16, 2).t(), coefs)
    with pytest.raises(ValueError):
        wa.weighted_agg_flat2d(torch.zeros(32)[::2], rows, coefs)
    with pytest.raises(TypeError):
        wa.weighted_agg_flat2d(g, rows, torch.zeros(2),
                               torch.tensor([0], dtype=torch.int64))


def test_vectorizable_follows_alignment():
    n = 1_663_370                      # the paper CNN: n ≡ 2 (mod 4)
    g = torch.empty(n)
    out = torch.empty(n)
    contiguous = torch.empty(3, n)
    padded = torch.empty(3, n + 62)[:, :n]     # 16-byte row stride
    assert not wa.vectorizable(g, contiguous, out)   # odd rows misaligned
    assert wa.vectorizable(g, contiguous[:1], out)   # one row: no stride
    assert wa.vectorizable(g, padded, out)
    assert not wa.vectorizable(g, padded[1:2, 1:], out[1:])
