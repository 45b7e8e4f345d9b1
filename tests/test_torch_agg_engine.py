"""The port's flat-buffer aggregation engine against the reference's.

Leaf order and offsets must be the reference's (checked bit for bit at
the paper CNN's full width), coefficients must be built exactly as the
reference builds them, and every blend variant must agree with the
reference engine (kernel mode, interpret) on the same numpy inputs:
f32 1e-6, bf16 the reference suite's own bound (tests/test_agg_engine.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import MNIST_CNN as J_MNIST_CNN
from repro.core import agg_engine as j_eng
from repro.core import aggregation as j_agg
from repro.models import cnn as j_cnn
from repro_torch.core import agg_engine as t_eng
from repro_torch.core import aggregation as t_agg
from repro_torch.models.cnn import params_from_jax

torch.set_num_threads(2)

ATOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _tree(dtype, ragged=True, seed=0):
    """Flat dict of numpy leaves; keys deliberately not in sorted order."""
    rng = np.random.default_rng(seed)
    shapes = {"zz": (33, 17), "b": (5,), "mid": (2, 3, 4), "a": (257,)} \
        if ragged else {"w": (8, 128), "v": (1024,), "u": (16, 128)}
    return {k: np.asarray(jnp.asarray(rng.normal(size=s), dtype),
                          np.float32) for k, s in shapes.items()}


def _clients(tree, C):
    return [{k: (x * (0.5 * i - 1.0) + i).astype(np.float32)
             for k, x in tree.items()} for i in range(C)]


def _j(tree, dtype):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _t(tree, dtype):
    return {k: torch.from_numpy(np.array(v)).to(getattr(torch, dtype))
            for k, v in tree.items()}


def _engines(tree, dtype):
    return (j_eng.AggEngine(_j(tree, dtype), mode="kernel", interpret=True),
            t_eng.AggEngine(_t(tree, dtype)))


def _close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               torch.as_tensor(b).float().numpy(),
                               atol=ATOL[dtype])


def test_flatten_matches_reference_at_full_width():
    """Leaf order (jax sorts dict keys) and offsets, bit for bit, at the
    paper CNN's n = 1,663,370."""
    w0 = jax.jit(j_cnn.init_params, static_argnums=0)(J_MNIST_CNN,
                                                      jax.random.PRNGKey(3))
    je = j_eng.AggEngine(w0)
    tp = params_from_jax({k: np.asarray(v) for k, v in w0.items()}, "cpu")
    te = t_eng.AggEngine(tp)
    assert te.n == je.n == 1_663_370
    assert te.names == ("conv1_b", "conv1_w", "conv2_b", "conv2_w",
                        "fc1_b", "fc1_w", "fc2_b", "fc2_w")
    assert te.offsets == je.offsets and te.shapes == je.shapes
    np.testing.assert_array_equal(te.flatten(tp).numpy(),
                                  np.asarray(je.flatten(w0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flatten_unflatten_roundtrip(dtype):
    tree = _t(_tree(dtype), dtype)
    eng = t_eng.AggEngine(tree)
    back = eng.unflatten(eng.flatten(tree))
    assert list(back) == sorted(tree)
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k], tree[k])


@pytest.mark.parametrize("beta", [0.7, 0.1, 1.0 / 3.0, 0.999999, 0.0])
def test_blend_coefficients_bitwise(beta):
    ref = np.asarray(jnp.stack([jnp.float32(beta),
                                1.0 - jnp.float32(beta)]))
    np.testing.assert_array_equal(t_eng._blend_coefs(beta), ref)


@pytest.mark.parametrize("dtype,ragged", [("float32", True),
                                          ("float32", False),
                                          ("bfloat16", True)])
def test_blend_flat_matches_reference(dtype, ragged):
    tree = _tree(dtype, ragged)
    client = {k: (-0.5 * v + 1.0).astype(np.float32) for k, v in tree.items()}
    je, te = _engines(tree, dtype)
    j_new, _ = je.blend_flat(je.flatten(_j(tree, dtype)), _j(client, dtype),
                             0.7)
    t_new, t_tree = te.blend_flat(te.flatten(_t(tree, dtype)),
                                  _t(client, dtype), 0.7)
    assert t_new.dtype == getattr(torch, dtype)
    _close(j_new, t_new, dtype)
    ref_tree = t_agg.blend_pytree(_t(tree, dtype), _t(client, dtype), 0.7)
    for k in tree:
        _close(ref_tree[k].float().numpy(), t_tree[k], dtype)


@pytest.mark.parametrize("dtype,K", [("float32", 1), ("float32", 5),
                                     ("float32", 8), ("bfloat16", 8)])
def test_blend_rows_flat_matches_reference(dtype, K):
    tree = _tree(dtype, seed=K)
    je, te = _engines(tree, dtype)
    rows = np.stack([np.asarray(je.flatten(_j(c, dtype)), np.float32)
                     for c in _clients(tree, K)])
    betas = [0.9, 0.5, 0.8, 0.95, 0.7, 0.6, 0.99, 0.85][:K]
    g = np.asarray(je.flatten(_j(tree, dtype)), np.float32)
    j_new = je.blend_rows_flat(jnp.asarray(g, dtype),
                               jnp.asarray(rows, dtype), betas)
    t_new = te.blend_rows_flat(torch.tensor(g).to(getattr(torch, dtype)),
                               torch.tensor(rows).to(getattr(torch,
                                                                 dtype)),
                               betas)
    _close(j_new, t_new, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_sum_matches_reference(dtype):
    """The FedAvg cycle: one C=M launch == eq. (2), pytree and row forms."""
    tree = _tree(dtype)
    M = 5
    clients = _clients(tree, M)
    alpha = list(j_agg.sfl_alpha([60, 80, 100, 120, 140]))
    je, te = _engines(tree, dtype)
    j_new, j_out = je.weighted_sum_flat(0.0, je.flatten(_j(tree, dtype)),
                                        alpha, [_j(c, dtype) for c in clients])
    t_new, t_out = te.weighted_sum_flat(0.0, te.flatten(_t(tree, dtype)),
                                        alpha, [_t(c, dtype) for c in clients])
    _close(j_new, t_new, dtype)
    for k in tree:
        _close(j_out[k], t_out[k], dtype)
    # row form over a fleet buffer
    rows = np.stack([np.asarray(je.flatten(_j(c, dtype)), np.float32)
                     for c in clients])
    g = np.asarray(je.flatten(_j(tree, dtype)), np.float32)
    j_new = je.weighted_sum_rows_flat(0.25, jnp.asarray(g, dtype),
                                      alpha, jnp.asarray(rows, dtype))
    tdt = getattr(torch, dtype)
    t_new = te.weighted_sum_rows_flat(0.25, torch.tensor(g).to(tdt),
                                      alpha, torch.tensor(rows).to(tdt))
    _close(j_new, t_new, dtype)


def test_row_addressed_blends_match_reference():
    """blend_row_flat / blend_rows_fleet / delta_row_flat against a fleet
    buffer held, as the plane holds it, at a padded row stride."""
    tree = _tree("float32")
    je, te = _engines(tree, "float32")
    M = 6
    rows = np.stack([np.asarray(je.flatten(_j(c, "float32")))
                     for c in _clients(tree, M)])
    g = np.asarray(je.flatten(_j(tree, "float32")))
    fleet = torch.zeros(M, te.n + 7)[:, :te.n]
    fleet.copy_(torch.tensor(rows))
    tg = torch.tensor(g)
    for cid, beta in ((0, 0.3), (3, 0.8), (5, 0.55)):
        _close(je.blend_row_flat(jnp.asarray(g), jnp.asarray(rows), cid,
                                 beta),
               te.blend_row_flat(tg, fleet, cid, beta), "float32")
        _close(je.delta_row_flat(jnp.asarray(g), jnp.asarray(rows), cid,
                                 0.4),
               te.delta_row_flat(tg, fleet, cid, 0.4), "float32")
    cids, betas = [4, 1, 4, 2, 0], [0.9, 0.6, 0.8, 0.7, 0.95]
    _close(je.blend_rows_fleet(jnp.asarray(g), jnp.asarray(rows), cids,
                               betas),
           te.blend_rows_fleet(tg, fleet, cids, betas), "float32")
    with pytest.raises(IndexError):
        te.blend_rows_fleet(tg, fleet, [M], [0.5])
    with pytest.raises(IndexError):
        te.blend_row_flat(tg, fleet, M, 0.5)


def test_torch_mode_matches_kernel_mode():
    """The plain MAC ("torch", twin of "xla") and the kernel path (the
    wrapper's plain version on the CPU) are the same math."""
    tree = _t(_tree("float32"), "float32")
    clients = [_t(c, "float32") for c in _clients(_tree("float32"), 4)]
    ek = t_eng.AggEngine(tree)
    et = t_eng.AggEngine(tree, mode="torch")
    g = ek.flatten(tree)
    rows = torch.stack([ek.flatten(c) for c in clients])
    betas = [0.9, 0.5, 0.8, 0.7]
    np.testing.assert_allclose(ek.blend_rows_flat(g, rows, betas).numpy(),
                               et.blend_rows_flat(g, rows, betas).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        ek.blend_rows_fleet(g, rows, [3, 1], [0.4, 0.6]).numpy(),
        et.blend_rows_fleet(g, rows, [3, 1], [0.4, 0.6]).numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        t_eng.AggEngine(tree, mode="xla")


def test_engine_cache_and_pow2_bucket():
    tree = _t(_tree("float32"), "float32")
    shifted = {k: v + 1 for k, v in tree.items()}
    assert t_eng.engine_for(tree) is t_eng.engine_for(shifted)
    assert t_eng.engine_for(tree) is not t_eng.engine_for(tree, mode="torch")
    for n in (1, 2, 3, 5, 8, 100, 1025):
        assert t_eng.pow2_bucket(n) == j_eng.pow2_bucket(n)
    with pytest.raises(ValueError):
        t_eng.pow2_bucket(0)


def test_weighted_sum_pytrees_matches_reference():
    tree = _tree("float32")
    clients = _clients(tree, 3)
    coefs = [0.3, 0.25, 0.25]
    ref = j_agg.weighted_sum_pytrees(0.2, _j(tree, "float32"), coefs,
                                     [_j(c, "float32") for c in clients])
    out = t_agg.weighted_sum_pytrees(0.2, _t(tree, "float32"), coefs,
                                     [_t(c, "float32") for c in clients])
    for k in tree:
        _close(ref[k], out[k], "float32")
