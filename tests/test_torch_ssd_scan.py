"""The port's SSD chunk scan against the reference's.

Same inputs (numpy from one seed, drawn as the reference's kernel tests
draw theirs) on both sides.  On the CPU the port's wrapper
``ssd_scan_fwd`` takes its plain version (``ref.ssd_chunked``); the
reference runs its Pallas kernel in interpret mode.  Tolerances: the
reference's own atol 5e-5 for the chunked and wrapped SSD against the
exact sequential recurrence (``tests/test_kernels.py``); wrapper against
the interpret-mode kernel and ``ops.ssd``'s gradient against ``jax.grad``
of the reference's ``ops.ssd`` 1e-5·(1+max|ref|) (f32 on both sides,
only the summation order differs).  The CUDA kernel itself is held
against the plain versions on the card (``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as j_ops
from repro.kernels.ssd_scan import ref as j_ref
from repro.kernels.ssd_scan import ssd_scan as j_ssd
from repro_torch.kernels.ssd_scan import ops as t_ops
from repro_torch.kernels.ssd_scan import ref as t_ref
from repro_torch.kernels.ssd_scan import ssd_scan as t_ssd

torch.set_num_threads(2)

SSD_CASES = [
    # Bt, L, H, P, G, N, chunk (tests/test_kernels.py)
    (2, 128, 4, 64, 1, 32, 32),
    (1, 256, 8, 64, 2, 64, 64),
    (2, 64, 4, 32, 4, 16, 16),
    (1, 128, 6, 64, 3, 128, 128),   # G=3 (zamba2-style grouped B/C)
]


def _inputs(Bt, L, H, P, G, N, seed):
    """x, dt, A, B, C as numpy f32: dt = softplus(normal)·0.1 and
    A = −exp(0.3·normal), as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bt, L, H, P))
    dt = np.log1p(np.exp(rng.normal(size=(Bt, L, H)))) * 0.1
    A = -np.exp(rng.normal(size=(H,)) * 0.3)
    B = rng.normal(size=(Bt, L, G, N))
    C = rng.normal(size=(Bt, L, G, N))
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


def _close(out, ref, atol=None, rel=1e-5):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == np.float32
    if atol is None:
        atol = rel * (1.0 + float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("Bt,L,H,P,G,N,chunk", SSD_CASES)
def test_chunked_and_sequential_match_reference_sequential(Bt, L, H, P, G,
                                                           N, chunk):
    arrs = _inputs(Bt, L, H, P, G, N, L + H)
    y_ref, s_ref = j_ref.ssd_sequential(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a) for a in arrs]
    for y, s in (t_ref.ssd_chunked(*ts, chunk=chunk),
                 t_ref.ssd_sequential(*ts),
                 t_ssd.ssd_scan_fwd(*ts, chunk=chunk)):
        _close(y, y_ref, atol=5e-5)
        _close(s, s_ref, atol=5e-5)


@pytest.mark.parametrize("case", [SSD_CASES[2], SSD_CASES[3]])
def test_wrapper_matches_reference_kernel(case):
    """The wrapper's CPU branch against the reference's Pallas kernel in
    interpret mode (one small case and the G = 3 case)."""
    Bt, L, H, P, G, N, chunk = case
    arrs = _inputs(Bt, L, H, P, G, N, 7 * H)
    y_ref, s_ref = j_ssd.ssd_scan_fwd(*map(jnp.asarray, arrs), chunk=chunk,
                                      interpret=True)
    before = t_ssd.ssd_scan_fwd.launches
    y, s = t_ssd.ssd_scan_fwd(*[torch.from_numpy(a) for a in arrs],
                              chunk=chunk)
    assert t_ssd.ssd_scan_fwd.launches == before      # no launch on a CPU
    _close(y, y_ref)
    _close(s, s_ref)


def test_ssd_gradient_matches_reference():
    """``ops.ssd``'s backward (autograd through the plain chunked op)
    against ``jax.grad`` of the reference's ``ops.ssd`` (its Pallas
    forward in interpret mode), for a loss reading y and the state."""
    Bt, L, H, P, G, N, chunk = 1, 64, 4, 32, 2, 16, 32
    arrs = _inputs(Bt, L, H, P, G, N, 11)
    rng = np.random.default_rng(12)
    wy = rng.normal(size=(Bt, L, H, P)).astype(np.float32)
    ws = rng.normal(size=(Bt, H, P, N)).astype(np.float32)

    def j_loss(*a):
        y, s = j_ops.ssd(*a, chunk, True)
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, s = t_ops.ssd(*ts, chunk=chunk)
    ((y * torch.from_numpy(wy)).sum()
     + (s * torch.from_numpy(ws)).sum()).backward()
    for t, g in zip(ts, j_grads):
        _close(t.grad, g)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 64, 4, 32, 2, 16, 1)]
    before = t_ssd.ssd_scan_fwd.launches
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        t_ssd.ssd_scan_fwd(*arrs, chunk=48)
    x, dt, A, B, C = arrs
    with pytest.raises(ValueError, match="built for chunk in"):
        t_ssd.ssd_scan_fwd(*arrs, chunk=8)         # chunk 8: not built
    with pytest.raises(ValueError, match="built for chunk in"):
        t_ssd.ssd_scan_fwd(x[..., :16], dt, A, B, C, chunk=32)     # P = 16
    with pytest.raises(ValueError, match="built for chunk in"):
        t_ssd.ssd_scan_fwd(x, dt, A, B[..., :8], C[..., :8], chunk=32)
    with pytest.raises(ValueError, match="G must divide H"):
        t_ssd.ssd_scan_fwd(x[:, :, :3], dt[:, :, :3], A[:3], B, C, chunk=32)
    with pytest.raises(TypeError, match="float32 dt"):
        t_ssd.ssd_scan_fwd(x, dt.double(), A, B, C, chunk=32)
    r = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="ops.ssd"):
        t_ssd.ssd_scan_fwd(r, dt, A, B, C, chunk=32)
    with torch.no_grad():                  # no grad mode: no graph to refuse
        t_ssd.ssd_scan_fwd(r, dt, A, B, C, chunk=32)
    assert t_ssd.ssd_scan_fwd.launches == before


def test_bf16_inputs_take_the_plain_version_in_f32():
    """x, B and C in bf16 are read as f32: the result equals the f32
    plain version on the bf16-rounded inputs, bit for bit."""
    arrs = [torch.from_numpy(a) for a in _inputs(2, 64, 4, 32, 1, 32, 3)]
    x, dt, A, B, C = arrs
    lo = [t.bfloat16() for t in (x, B, C)]
    y, s = t_ssd.ssd_scan_fwd(lo[0], dt, A, lo[1], lo[2], chunk=32)
    y32, s32 = t_ref.ssd_chunked(lo[0].float(), dt, A, lo[1].float(),
                                 lo[2].float(), chunk=32)
    assert y.dtype == s.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(s, s32)
