"""The port's Mamba2 (mamba2-780m) against ``repro.models`` and
``repro.launch.serve`` on reduced configs.

Same parameters (the reference's, carried over by ``params_from_jax``,
with the norm scales, the conv bias and D moved off their init values) and the same inputs (numpy from one seed) on both
sides.  Tolerances: the block's parts and the whole model's logits and
caches 1e-5·(1+max|ref|), greedy tokens equal (f32 on both sides, only
the summation order differs); forward against step-by-step decode
within the port at the reference's own atol 2e-4
(``tests/test_models.py``).  On the CPU every SSD takes the kernel's
plain version; the reference runs its default path (``ssd_chunked``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as j_serve
from repro.models import mamba2 as j_m2
from repro.models import transformer as j_tm
from repro_torch.configs import base as t_base
from repro_torch.kernels.ssd_scan import ssd_scan as t_ssd
from repro_torch.launch import serve as t_serve
from repro_torch.models import mamba2 as t_m2
from repro_torch.models import transformer as t_tm
from test_torch_lm import (_model, _perturbed, _to_jax, assert_close,
                           port_config)

torch.set_num_threads(2)

ARCH = "mamba2-780m"


def _mixer(seed=0):
    jcfg = j_get_config(ARCH).reduced()
    p = _perturbed(j_m2.mamba2_init(jax.random.PRNGKey(seed), jcfg),
                   np.random.default_rng(seed))
    return jcfg, port_config(jcfg), p, \
        {k: torch.from_numpy(v.copy()) for k, v in p.items()}


# ---------------------------------------------------------------------------
# Config and parameters
# ---------------------------------------------------------------------------
def test_config_registered_as_in_reference():
    tcfg = t_base.get_config(ARCH)
    jcfg = j_get_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.d_inner, tcfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads) \
        == (3072, 48)
    assert tcfg.param_count == jcfg.param_count == 780_148_992


def test_init_has_reference_layout():
    """mamba2_init's names, shapes and dtypes are the reference's, and so
    is the whole reduced model's parameter tree."""
    jcfg, tcfg, _, tp = _mixer()
    ours = t_m2.mamba2_init(torch.Generator().manual_seed(0), tcfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in ours.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    assert list(ours) == list(j_m2.mamba2_init(jax.random.PRNGKey(0), jcfg))
    assert bool((ours["A_log"] >= 0).all()) and bool(
        (ours["A_log"] <= np.log(16.0)).all())
    _, _, np_params = _model(ARCH)
    shapes = lambda t: jax.tree.map(lambda x: (tuple(x.shape), x.dtype), t)
    full = t_tm.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert shapes(full) == shapes(t_tm.params_from_jax(np_params, tcfg,
                                                       "cpu"))
    assert t_tm.num_params(full) == tcfg.param_count


# ---------------------------------------------------------------------------
# The block's parts
# ---------------------------------------------------------------------------
def test_conv_and_norm_match_reference():
    jcfg, tcfg, jp, tp = _mixer()
    rng = np.random.default_rng(1)
    conv_dim = jp["conv_w"].shape[1]
    x = rng.normal(size=(2, 13, conv_dim)).astype(np.float32)
    assert_close(t_m2.causal_conv1d(torch.from_numpy(x), tp["conv_w"],
                                    tp["conv_b"]),
                 j_m2.causal_conv1d(jnp.asarray(x), jp["conv_w"],
                                    jp["conv_b"]))
    state = rng.normal(size=(2, 3, conv_dim)).astype(np.float32)
    y, new = t_m2.conv1d_decode_step(torch.from_numpy(state),
                                     torch.from_numpy(x[:, 0]),
                                     tp["conv_w"], tp["conv_b"])
    jy, jnew = j_m2.conv1d_decode_step(jnp.asarray(state),
                                       jnp.asarray(x[:, 0]), jp["conv_w"],
                                       jp["conv_b"])
    assert_close(y, jy)
    assert_close(new, jnew)
    h = rng.normal(size=(2, 5, tcfg.d_inner)).astype(np.float32)
    z = rng.normal(size=(2, 5, tcfg.d_inner)).astype(np.float32)
    assert_close(t_m2._gated_rmsnorm(tp["norm_scale"], torch.from_numpy(h),
                                     torch.from_numpy(z), 1e-6),
                 j_m2._gated_rmsnorm(jp["norm_scale"], jnp.asarray(h),
                                     jnp.asarray(z), 1e-6))


@pytest.mark.parametrize("L", [45, 64, 2])
def test_forward_and_state_match_reference(L):
    """mamba2_forward at a ragged L (padded to the chunk), a whole number
    of chunks and an L shorter than the conv window, and the conv and
    SSM states it writes into a cache, against the reference's forward
    and ``_mamba_prefill_state``; then 3 decode steps."""
    from repro.models import blocks as j_blocks

    jcfg, tcfg, jp, tp = _mixer()
    x = np.random.default_rng(2).normal(
        size=(2, L, jcfg.d_model)).astype(np.float32)
    ref = j_m2.mamba2_forward(jp, jnp.asarray(x), jcfg)
    cache = t_m2.init_mamba_cache(tcfg, 2, torch.float32)
    out = t_m2.mamba2_forward(tp, torch.from_numpy(x), tcfg, cache=cache)
    assert_close(out, ref)
    jc = j_blocks._mamba_prefill_state(
        jp, jnp.asarray(x), jcfg, j_m2.init_mamba_cache(jcfg, 2,
                                                        jnp.float32))
    assert_close(cache["ssm"], jc["ssm"])
    keep = jcfg.ssm.d_conv - 1
    if L < keep:       # the reference's conv state is L rows; the port's
        # has zeros in front, as the causal conv pads
        assert_close(cache["conv"][:, keep - L:], jc["conv"])
        assert not bool(cache["conv"][:, :keep - L].any())
        return
    assert_close(cache["conv"], jc["conv"])
    for t in range(3):
        xt = np.random.default_rng(10 + t).normal(
            size=(2, 1, jcfg.d_model)).astype(np.float32)
        ref, jc = j_m2.mamba2_decode(jp, jnp.asarray(xt), jc, jcfg)
        out, cache = t_m2.mamba2_decode(tp, torch.from_numpy(xt), cache, tcfg)
        assert_close(out, ref)
        assert_close(cache["conv"], jc["conv"])
        assert_close(cache["ssm"], jc["ssm"])


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    Bt, H, P, G, N = 2, 6, 32, 3, 16
    state, x, B, C = (rng.normal(size=s).astype(np.float32) for s in (
        (Bt, H, P, N), (Bt, H, P), (Bt, G, N), (Bt, G, N)))
    dt = (np.log1p(np.exp(rng.normal(size=(Bt, H)))) * 0.1).astype(
        np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    args = (state, x, dt, A, B, C)
    y, s = t_m2.ssd_decode_step(*[torch.from_numpy(a) for a in args])
    jy, js = j_m2.ssd_decode_step(*map(jnp.asarray, args))
    assert_close(y, jy)
    assert_close(s, js)


def test_forward_agrees_with_step_by_step_decode():
    """Twin of the reference's test_mamba_forward_decode_agree, on the
    port's own init."""
    tcfg = t_base.get_config(ARCH).reduced()
    p = t_m2.mamba2_init(torch.Generator().manual_seed(0), tcfg)
    B, L = 2, 48
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, L + 1, tcfg.d_model)).astype(np.float32) * 0.1)
    y_full = t_m2.mamba2_forward(p, x, tcfg)
    cache = t_m2.init_mamba_cache(tcfg, B, torch.float32)
    outs = []
    for t in range(L + 1):
        y_t, cache = t_m2.mamba2_decode(p, x[:, t:t + 1], cache, tcfg)
        outs.append(y_t)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_full.numpy(),
                               atol=2e-4)


# ---------------------------------------------------------------------------
# Whole model: forward, prefill + decode through params_from_jax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stacked,S", [(False, 40), (True, 64)])
def test_model_matches_reference(stacked, S):
    """Reduced mamba2-780m from the reference's unrolled and stacked
    (``scan_layers=True``, 3 layers) parameters: forward logits, then
    prefill + 8 greedy decode steps, logits and caches ≤1e-5·(1+max),
    tokens equal; the parameters and caches convert back exactly."""
    jcfg, tcfg, np_params = _model(ARCH, stacked)
    assert bool(np_params["stack"]["period"]) == stacked
    jp = _to_jax(np_params)
    tp = t_tm.params_from_jax(np_params, tcfg, "cpu")
    back = t_tm.params_to_numpy(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(back), jax.tree.leaves(np_params)))
    B, steps = 2, 8
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    ref, _ = j_tm.forward(jp, jcfg, {"tokens": jnp.asarray(tokens,
                                                           jnp.int32)})
    out, _ = t_tm.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert_close(out, ref)

    jc = j_tm.init_cache(jcfg, B, S + steps, dtype=jnp.float32)
    tc = t_tm.init_cache(tcfg, B, S + steps, dtype=torch.float32,
                         device="cpu")
    ref, jc = j_tm.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)}, jc)
    out, tc = t_tm.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)},
                           tc)
    for step in range(steps + 1):
        assert_close(out, ref)
        ref_c = jax.tree.map(np.asarray, jc)
        port_c = t_tm.caches_to_numpy(tc, tcfg)
        assert jax.tree.structure(port_c) == jax.tree.structure(ref_c)
        for a, b in zip(jax.tree.leaves(port_c), jax.tree.leaves(ref_c)):
            assert_close(a, b)
        jtok = np.asarray(jnp.argmax(ref[:, -1], axis=-1))
        ttok = torch.argmax(out[:, -1], dim=-1).numpy()
        assert np.array_equal(jtok, ttok)
        if step == steps:
            break
        ref, jc = j_tm.decode_step(jp, jcfg, jnp.asarray(jtok[:, None],
                                                         jnp.int32),
                                   jc, jnp.int32(S + step))
        out, tc = t_tm.decode_step(tp, tcfg, torch.from_numpy(ttok[:, None]),
                                   tc, S + step)
    assert t_ssd.ssd_scan_fwd.launches == 0          # the plain version


def test_caches_round_trip_stacked():
    jcfg, tcfg, _ = _model(ARCH, stacked=True)
    ref = jax.tree.map(np.asarray, j_tm.init_cache(jcfg, 2, 12))
    rng = np.random.default_rng(3)
    ref = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype),
                       ref)
    back = t_tm.caches_to_numpy(t_tm.caches_from_jax(ref, tcfg, "cpu"),
                                tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert np.array_equal(a, b.astype(a.dtype))   # bf16 exact in f32


def test_batched_server_matches_reference():
    """Reduced mamba2-780m through both servers: ragged prompts padded to
    the chunk, slots refilled, equal tokens request for request."""
    jcfg, tcfg, np_params = _model(ARCH)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (12, 9, 40, 10, 33)]
    gen, slots, max_len = 5, 2, 40 + 5 + 4
    jdone = j_serve.BatchedServer(jcfg, _to_jax(np_params), slots=slots,
                                  max_len=max_len).run(
        [j_serve.Request(i, p, gen) for i, p in enumerate(prompts)])
    tdone = t_serve.BatchedServer(
        tcfg, t_tm.params_from_jax(np_params, tcfg, "cpu"), slots=slots,
        max_len=max_len).run(
        [t_serve.Request(i, p, gen) for i, p in enumerate(prompts)])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.generated for r in tdone] == [r.generated for r in jdone]
    assert all(len(r.generated) == gen for r in tdone)
