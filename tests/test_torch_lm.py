"""The port's dense-decoder LM stack against ``repro.models`` on reduced
configs.

Same parameters (the reference's, carried over by ``params_from_jax``
with norm scales and QKV biases moved off zero) and the same token ids
(numpy from one seed) on both sides.  Tolerances: layers and attention
1e-5·(1+max|ref|); whole-model logits and caches 1e-5·(1+max|ref|),
``slot_pos`` and greedy tokens equal.  On the CPU the port's
``attn_impl="pallas"`` takes the flash kernel's plain version; the
reference runs its Pallas kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_ids
from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as j_tm
from repro_torch.configs import base as t_base
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tm

torch.set_num_threads(2)

LM_ARCHS = [a for a in all_arch_ids() if a != "paper-cnn"]


def port_config(jcfg) -> t_base.ModelConfig:
    """The reference's config, field for field, as the port's type."""
    d = dataclasses.asdict(jcfg)
    d["attention"] = t_base.AttentionConfig(**d["attention"])
    d["moe"] = t_base.MoEConfig(**d["moe"]) if d["moe"] else None
    d["ssm"] = t_base.SSMConfig(**d["ssm"]) if d["ssm"] else None
    return t_base.ModelConfig(**d)


def assert_close(out, ref, tol=1e-5):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref,
                               atol=tol * (1.0 + float(np.abs(ref).max())))


# leaves initialised to a constant: norm scales, biases, and Mamba2's
# gated-norm scale, conv bias and skip weight D
OFF_INIT = ("scale", "bq", "bk", "bv", "norm_scale", "conv_b", "D")


def _perturbed(tree, rng):
    """numpy copy of a reference param tree with the constant-initialised
    leaves moved off their init values, so the (1+scale) norms, the bias
    adds and the skip are exercised."""
    if isinstance(tree, dict):
        return {k: (np.asarray(v) + rng.normal(0, 0.1, np.shape(v))
                    .astype(np.float32)
                    if k in OFF_INIT
                    else _perturbed(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_perturbed(v, rng) for v in tree]
    return np.asarray(tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_config_matches_reference(arch):
    jcfg = j_get_config(arch)
    tcfg = port_config(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    for c, j in ((tcfg, jcfg), (tcfg.reduced(), jcfg.reduced())):
        assert c.resolved_head_dim == j.resolved_head_dim
        assert c.block_pattern == j.block_pattern
        assert c.blocks == j.blocks
        assert c.param_count == j.param_count


def test_qwen2_registered_as_in_reference():
    tcfg = t_base.get_config("qwen2-0.5b")
    assert dataclasses.asdict(tcfg) == \
        dataclasses.asdict(j_get_config("qwen2-0.5b"))
    assert tcfg.param_count == 494_032_768
    assert t_base.all_arch_ids() == ["mamba2-780m", "qwen2-0.5b"]
    with pytest.raises(KeyError, match="13"):
        t_base.get_config("mixtral-8x7b")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    scale = rng.normal(0, 0.3, 32).astype(np.float32)
    assert_close(t_layers.rmsnorm({"scale": torch.from_numpy(scale)},
                                  torch.from_numpy(x), 1e-6),
                 j_layers.rmsnorm({"scale": jnp.asarray(scale)},
                                  jnp.asarray(x), 1e-6))
    assert_close(t_layers.softcap(torch.from_numpy(x) * 40, 30.0),
                 j_layers.softcap(jnp.asarray(x) * 40, 30.0))
    h = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9) + 500
    for theta in (1e4, 1e6):
        assert_close(t_layers.rope_frequencies(16, theta),
                     j_layers.rope_frequencies(16, theta))
        assert_close(t_layers.apply_rope(torch.from_numpy(h),
                                         torch.from_numpy(pos), theta),
                     j_layers.apply_rope(jnp.asarray(h), jnp.asarray(pos),
                                         theta))
    for gated in (True, False):
        p = {k: rng.normal(0, 0.2, s).astype(np.float32) for k, s in
             (("w_in", (32, 48)), ("w_gate", (32, 48)),
              ("w_out", (48, 32)))}
        if not gated:
            del p["w_gate"]
        assert_close(
            t_layers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), gated=gated),
            j_layers.mlp(_to_jax(p), jnp.asarray(x), gated=gated))
    table = rng.normal(size=(50, 32)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 5))
    for scaled in (True, False):
        assert_close(
            t_layers.embed_lookup(torch.from_numpy(table),
                                  torch.from_numpy(ids),
                                  scale_by_sqrt_dim=scaled),
            j_layers.embed_lookup(jnp.asarray(table), jnp.asarray(ids),
                                  scale_by_sqrt_dim=scaled))
    assert_close(t_layers.unembed(torch.from_numpy(x),
                                  torch.from_numpy(table), 30.0),
                 j_layers.unembed(jnp.asarray(x), jnp.asarray(table), 30.0))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _attn_setup(window=0, cap=0.0, seed=0):
    base = j_get_config("qwen2-0.5b").reduced()
    jcfg = dataclasses.replace(base, attention=dataclasses.replace(
        base.attention, sliding_window=window, attn_logit_softcap=cap))
    tcfg = port_config(jcfg)
    rng = np.random.default_rng(seed)
    p = _perturbed(j_attn.attention_init(jax.random.PRNGKey(seed), jcfg),
                   rng)
    return jcfg, tcfg, p, {k: torch.from_numpy(v.copy())
                           for k, v in p.items()}, \
        rng


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (8, 0.0), (0, 50.0)])
def test_attention_forward_matches(impl, window, cap):
    jcfg, tcfg, jp, tp, rng = _attn_setup(window, cap)
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    ref, (rk, rv) = j_attn.attention_forward(
        _to_jax(jp), jnp.asarray(x), jcfg, window=window, impl=impl,
        kv_cache_out=True)
    out, (k, v) = t_attn.attention_forward(
        tp, torch.from_numpy(x), tcfg, window=window, impl=impl,
        kv_cache_out=True)
    assert_close(out, ref)
    assert_close(k, rk)
    assert_close(v, rv)


@pytest.mark.parametrize("window,S", [(0, 10), (16, 10), (16, 24),
                                      (16, 16)])
def test_kv_cache_and_decode_match(window, S):
    """fill_kv_cache (ring when S >= L) then decode_attention steps."""
    jcfg, tcfg, jp, tp, rng = _attn_setup(window)
    B, max_len = 2, 32
    k = rng.normal(size=(B, S, 2, 64)).astype(np.float32)
    v = rng.normal(size=(B, S, 2, 64)).astype(np.float32)
    jc = j_attn.fill_kv_cache(
        j_attn.init_kv_cache(jcfg, B, max_len, window, jnp.float32),
        jnp.asarray(k), jnp.asarray(v))
    tc = t_attn.fill_kv_cache(
        t_attn.init_kv_cache(tcfg, B, max_len, window, torch.float32),
        torch.from_numpy(k), torch.from_numpy(v))
    jp = _to_jax(jp)
    for step in range(4):
        for name in ("k", "v"):
            assert_close(tc[name], jc[name])
        assert np.array_equal(tc["slot_pos"].numpy(),
                              np.asarray(jc["slot_pos"]))
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        ref, jc = j_attn.decode_attention(jp, jnp.asarray(x), jc, jcfg,
                                          pos=jnp.int32(S + step),
                                          window=window)
        out, tc = t_attn.decode_attention(tp, torch.from_numpy(x), tc,
                                          tcfg, pos=S + step, window=window)
        assert_close(out, ref)


# ---------------------------------------------------------------------------
# Whole model: prefill + decode through params_from_jax
# ---------------------------------------------------------------------------
def _model(arch, stacked=False, seed=0):
    jcfg = j_get_config(arch).reduced()
    if stacked:
        jcfg = dataclasses.replace(jcfg, scan_layers=True, num_layers=3)
    tcfg = port_config(jcfg)
    np_params = _perturbed(
        j_tm.init_params(jcfg, jax.random.PRNGKey(seed)),
        np.random.default_rng(seed))
    return jcfg, tcfg, np_params


@pytest.mark.parametrize("arch,stacked,S", [
    ("qwen2-0.5b", False, 40),
    ("qwen2-0.5b", True, 40),        # scan_layers, n_full = 3: stacked
    ("gemma2-9b", False, 80),        # local/global, softcaps, post norms,
                                     # ring cache (S > window 64)
    ("starcoder2-3b", False, 72),    # plain GELU MLP, untied head, window
])
def test_prefill_and_decode_match_reference(arch, stacked, S):
    jcfg, tcfg, np_params = _model(arch, stacked)
    if stacked:
        assert np_params["stack"]["period"]
    jp = _to_jax(np_params)
    tp = t_tm.params_from_jax(np_params, tcfg, "cpu")
    assert t_tm.num_params(tp) == j_tm.num_params(jp) == tcfg.param_count
    B, steps = 2, 8
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    jc = j_tm.init_cache(jcfg, B, S + steps, dtype=jnp.float32)
    tc = t_tm.init_cache(tcfg, B, S + steps, dtype=torch.float32,
                         device="cpu")
    ref, jc = j_tm.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)},
                           jc, attn_impl="pallas")
    out, tc = t_tm.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)},
                           tc, attn_impl="pallas")
    for step in range(steps + 1):
        assert_close(out, ref)
        ref_c = jax.tree.map(np.asarray, jc)
        port_c = t_tm.caches_to_numpy(tc, tcfg)
        assert jax.tree.structure(port_c) == jax.tree.structure(ref_c)
        for a, b in zip(jax.tree.leaves(port_c), jax.tree.leaves(ref_c)):
            if b.dtype == np.int32:
                assert np.array_equal(a, b)
            else:
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


def test_caches_round_trip_stacked():
    jcfg, tcfg, _ = _model("qwen2-0.5b", stacked=True)
    ref = jax.tree.map(np.asarray, j_tm.init_cache(jcfg, 2, 12))
    rng = np.random.default_rng(3)
    ref = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype)
                       if a.dtype != np.int32 else a, ref)
    back = t_tm.caches_to_numpy(t_tm.caches_from_jax(ref, tcfg, "cpu"),
                                tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert np.array_equal(a, b.astype(a.dtype))   # bf16 exact in f32


def test_init_params_has_reference_layout():
    jcfg, tcfg, np_params = _model("qwen2-0.5b")
    ours = t_tm.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    conv = t_tm.params_from_jax(np_params, tcfg, "cpu")
    shapes = lambda t: jax.tree.map(lambda x: (tuple(x.shape), x.dtype), t)
    assert shapes(ours) == shapes(conv)
    logits, _ = t_tm.forward(ours, tcfg, {"tokens": torch.zeros(
        1, 4, dtype=torch.long)})
    assert logits.shape == (1, 4, tcfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# What the slice does not cover raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,item", [
    ("mixtral-8x7b", "#13c"), ("granite-moe-1b-a400m", "#13c"),
    ("zamba2-7b", "#13d"),
    ("seamless-m4t-large-v2", "#13e"), ("llava-next-34b", "#13e")])
def test_unported_families_raise(arch, item):
    tcfg = port_config(j_get_config(arch).reduced())
    with pytest.raises(NotImplementedError, match=item):
        t_tm.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")


@pytest.mark.parametrize("impl,S", [("blockwise", 8), ("auto", 2049)])
def test_blockwise_raises(impl, S):
    jcfg, tcfg, _, tp, _ = _attn_setup()
    x = torch.zeros(1, S, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="#13b"):
        t_attn.attention_forward(tp, x, tcfg, window=0, impl=impl)


def test_entry_points_need_the_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tcfg = t_base.get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tm.init_cache(tcfg, 1, 8)
    # a CPU generator does not put the parameters on the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tm.init_params(tcfg, torch.Generator().manual_seed(0))
