"""The port's federated LM training against ``repro`` on reduced qwen2.

Same parameters (the reference's, carried over by ``params_from_jax``
with norm scales and QKV biases moved off zero), same token ids (numpy
from one seed, or both packages' ``TokenStream``) on both sides.  The
reference's fused step runs under a 1×1 host mesh, as its own tests run
it.  On the CPU the port's ``attn_impl="pallas"`` takes the flash
kernels' plain versions (forward and backward); the reference runs its
Pallas kernels in interpret mode.  Tolerances: losses 1e-5·(1+|ref|);
gradients and updated parameters 1e-5·(1+max|ref|) per leaf; token
draws, coefficient vectors and trunks equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import FederatedConfig as JFed
from repro.configs.base import MeshConfig
from repro.core import distributed as j_dist
from repro.data.synthetic import TokenStream as JStream
from repro.launch import train as j_train
from repro.models import layers as j_layers
from repro.models import transformer as j_tm
from repro_torch._tree import leaves, tree_map
from repro_torch.configs import base as t_base
from repro_torch.core import aggregation as t_agg
from repro_torch.core import distributed as t_dist
from repro_torch.data.synthetic import TokenStream as TStream
from repro_torch.launch import train as t_train
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tm

torch.set_num_threads(2)

HOST_MESH = MeshConfig((1, 1), ("data", "model"))
ATTN = ["naive", "pallas"]


def _mesh():
    from repro.launch.mesh import make_mesh
    return make_mesh((1, 1), ("data", "model"))


def _perturbed(tree, rng):
    """numpy copy of a reference param tree with norm scales and biases
    off zero, so the (1+scale) norms and the bias adds are exercised."""
    if isinstance(tree, dict):
        return {k: (np.asarray(v) + rng.normal(0, 0.1, np.shape(v))
                    .astype(np.float32)
                    if k in ("scale", "bq", "bk", "bv")
                    else _perturbed(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_perturbed(v, rng) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def model():
    """Reduced qwen2-0.5b (2 layers): (port cfg, ref cfg, numpy params)."""
    jcfg = j_get_config("qwen2-0.5b").reduced()
    tcfg = t_base.get_config("qwen2-0.5b").reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    params = _perturbed(j_tm.init_params(jcfg, jax.random.PRNGKey(0)),
                        np.random.default_rng(1))
    return tcfg, jcfg, params


def _assert_trees_close(port_np, ref, tol=1e-5):
    """Leaf by leaf in the reference's layout: |Δ| ≤ tol·(1+max|ref|)."""
    got, want = jax.tree.leaves(port_np), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        np.testing.assert_allclose(
            a, b, atol=tol * (1.0 + float(np.abs(b).max())), rtol=0)


def _batches(cfg, C, K, b, S, seed):
    rng = np.random.default_rng(seed)
    return {n: rng.integers(0, cfg.vocab_size, (C, K, b, S)).astype(np.int32)
            for n in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# TokenStream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab", [512, 151936])
@pytest.mark.parametrize("seed,cid", [(0, 0), (0, 3), (1, 2), (7, 5)])
def test_token_stream_draws_equal(vocab, seed, cid):
    j, t = JStream(vocab, cid=cid, seed=seed), TStream(vocab, cid=cid,
                                                       seed=seed)
    np.testing.assert_array_equal(t.p, j.p)
    for shape in ((2, 16), (3, 9), (1, 33)):
        a, b = t.sample_batch(*shape), j.sample_batch(*shape)
        for name in ("tokens", "labels"):
            assert a[name].dtype == np.int32
            np.testing.assert_array_equal(a[name], b[name])


# ---------------------------------------------------------------------------
# Losses and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    ref = j_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    out = t_layers.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 None if mask is None
                                 else torch.from_numpy(mask))
    assert abs(float(out) - float(ref)) <= 1e-5 * (1 + abs(float(ref)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_chunked_cross_entropy_matches_reference(weighted, cap):
    """S = 40 over chunks of 16: the reference pads its last chunk, the
    port takes a shorter one; a label of -1 is an invalid token."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 40, 24)).astype(np.float32)
    table = rng.normal(size=(64, 24)).astype(np.float32) * 0.3
    labels = rng.integers(0, 64, (3, 40)).astype(np.int32)
    labels[1, 5] = -1
    rw = rng.random(3).astype(np.float32) if weighted else None
    ref = j_tm.chunked_cross_entropy(
        jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels),
        final_softcap=cap, chunk=16,
        row_weights=None if rw is None else jnp.asarray(rw))
    out = t_tm.chunked_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(table),
        torch.from_numpy(labels), final_softcap=cap, chunk=16,
        row_weights=None if rw is None else torch.from_numpy(rw))
    assert abs(float(out) - float(ref)) <= 1e-5 * (1 + abs(float(ref)))


@pytest.mark.parametrize("attn", ATTN)
@pytest.mark.parametrize("mode", ["full", "chunked", "row_weights"])
def test_loss_and_grads_match_reference(model, attn, mode):
    tcfg, jcfg, params = model
    b = _batches(tcfg, 1, 1, 3, 24, 4)
    batch = {n: x[0, 0] for n, x in b.items()}
    if mode == "row_weights":
        batch["row_weights"] = np.asarray([0.5, 0.2, 0.3], np.float32) / 24
    chunked = mode == "chunked" or None

    def j_loss(p):
        return j_tm.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch),
                            attn_impl=attn, chunked=chunked)[0]

    ref_loss, ref_grads = jax.value_and_grad(j_loss)(
        jax.tree.map(jnp.asarray, params))
    tp = t_tm.params_from_jax(params, tcfg, "cpu")
    tb = {n: torch.from_numpy(x) for n, x in batch.items()}
    loss, grads = t_dist._value_and_grad(tp, tcfg, tb, attn) \
        if chunked is None else _grads_chunked(tp, tcfg, tb, attn)
    assert abs(float(loss) - float(ref_loss)) <= \
        1e-5 * (1 + abs(float(ref_loss)))
    _assert_trees_close(t_tm.params_to_numpy(grads, tcfg), ref_grads)


def _grads_chunked(tp, tcfg, tb, attn):
    live = [t.requires_grad_(True) for t in leaves(tp)]
    loss, metrics = t_tm.loss_fn(tp, tcfg, tb, attn_impl=attn, chunked=True)
    assert float(metrics["aux"]) == 0.0
    it = iter(torch.autograd.grad(loss, live))
    return loss.detach(), tree_map(lambda _: next(it), tp)


def test_params_round_trip(model):
    tcfg, _, params = model
    back = t_tm.params_to_numpy(t_tm.params_from_jax(params, tcfg, "cpu"),
                                tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The fused step
# ---------------------------------------------------------------------------
STEP_CASES = {
    # name: (C, K, b, grad_accum, coefs)
    "k1_csmaafl": (3, 1, 2, 1, [0.2, 0.5, 0.2, 0.1]),
    "k1_fedavg": (2, 1, 2, 1, [0.0, 0.5, 0.5]),
    "k1_grad_accum2": (2, 1, 4, 2, [0.1, 0.6, 0.3]),
    "k2": (2, 2, 2, 1, [0.4, 0.3, 0.3]),
}


@pytest.mark.parametrize("attn", ATTN)
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_fused_step_matches_reference(model, case, attn):
    tcfg, jcfg, params = model
    C, K, b, M, coefs = STEP_CASES[case]
    batches = _batches(tcfg, C, K, b, 16, 5)
    coefs = np.asarray(coefs, np.float32)
    with _mesh():
        ref, ref_m = j_dist.csmaafl_train_step(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, batches), jnp.asarray(coefs),
            jnp.float32(1e-2), cfg=jcfg,
            fed=JFed(local_steps=K, grad_accum=M), mesh_cfg=HOST_MESH,
            attn_impl=attn)
    step = t_dist.make_csmaafl_step(
        tcfg, t_base.FederatedConfig(local_steps=K, grad_accum=M),
        attn_impl=attn, device="cpu")
    new, metrics = step(t_tm.params_from_jax(params, tcfg, "cpu"), batches,
                        coefs, 1e-2)
    _assert_trees_close(t_tm.params_to_numpy(new, tcfg), ref)
    np.testing.assert_allclose(
        metrics["loss_per_client"].numpy(),
        np.asarray(ref_m["loss_per_client"]),
        atol=1e-5 * (1 + float(np.abs(ref_m["loss_per_client"]).max())))
    assert float(metrics["coef0"]) == float(coefs[0])
    assert int(metrics["num_clients"]) == C


@pytest.mark.parametrize("attn", ATTN)
@pytest.mark.parametrize("case", ["k1_csmaafl", "k1_grad_accum2"])
def test_fused_grads_match_reference(model, case, attn):
    """The K=1 step's gradient itself (the folded rows, micro-batches
    summed), against ``jax.grad`` of the reference's loss on the same
    rows with weights c_client / tokens_per_client, ≤1e-5·(1+max|g|) per
    leaf; and the step is exactly one SGD update with that gradient."""
    tcfg, jcfg, params = model
    C, K, b, M, coefs = STEP_CASES[case]
    S = 16
    batches = _batches(tcfg, C, K, b, S, 8)
    coefs = np.asarray(coefs, np.float32)
    flat = {n: x.reshape(C * b, S) for n, x in batches.items()}
    flat["row_weights"] = np.repeat(coefs[1:], b) / np.float32(b * S)

    def j_loss(p):
        return j_tm.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, flat),
                            attn_impl=attn)[0]

    ref_grads = jax.grad(j_loss)(jax.tree.map(jnp.asarray, params))
    fed = t_base.FederatedConfig(grad_accum=M)
    p0 = t_tm.params_from_jax(params, tcfg, "cpu")
    tb = {n: torch.from_numpy(x).long() for n, x in batches.items()}
    _, grads = t_dist.fused_value_and_grad(
        p0, tb, torch.from_numpy(coefs[1:]), cfg=tcfg, fed=fed,
        attn_impl=attn)
    _assert_trees_close(t_tm.params_to_numpy(grads, tcfg), ref_grads)
    step = t_dist.make_csmaafl_step(tcfg, fed, attn_impl=attn, device="cpu")
    new, _ = step(p0, batches, coefs, 1e-2)
    for a, w, g in zip(leaves(new), leaves(p0), leaves(grads)):
        assert torch.equal(a, w - 1e-2 * g.float())


def test_k1_fast_path_equals_explicit_per_client(model):
    """The reference's invariant, inside the port: the K=1 step equals
    c0·w + Σ_c c_c·(w − lr·∇mean_c) computed client by client."""
    tcfg, _, params = model
    C, lr = 3, 1e-2
    batches = _batches(tcfg, C, 1, 2, 16, 6)
    coefs = np.asarray([0.2, 0.5, 0.2, 0.1], np.float32)
    p0 = t_tm.params_from_jax(params, tcfg, "cpu")
    step = t_dist.make_csmaafl_step(tcfg, t_base.FederatedConfig(),
                                    device="cpu")
    new, _ = step(p0, batches, coefs, lr)
    locals_ = []
    for c in range(C):
        tb = {n: torch.from_numpy(x[c, 0]).long() for n, x in batches.items()}
        _, g = t_dist._value_and_grad(p0, tcfg, tb, "auto")
        locals_.append(tree_map(lambda w, gr: w - lr * gr, p0, g))
    client_leaves = [leaves(p) for p in locals_]
    ref = [t_agg.weighted_sum_pytrees(
        float(coefs[0]), {"w": w0}, [float(x) for x in coefs[1:]],
        [{"w": lv[i]} for lv in client_leaves])["w"]
        for i, w0 in enumerate(leaves(p0))]
    for a, b in zip(leaves(new), ref):
        assert float((a - b).abs().max()) <= 2e-5


def test_k1_fedavg_coefs_is_plain_sgd_on_weighted_mean(model):
    """The reference's invariant, inside the port: coefs [0, ½, ½] is one
    SGD step on the mean of the two clients' losses."""
    tcfg, _, params = model
    batches = _batches(tcfg, 2, 1, 2, 16, 7)
    p0 = t_tm.params_from_jax(params, tcfg, "cpu")
    step = t_dist.make_sfl_step(tcfg, t_base.FederatedConfig(),
                                device="cpu")
    new, _ = step(p0, batches, [0.0, 0.5, 0.5], 1e-2)
    live = [t.detach().clone().requires_grad_(True)
            for t in leaves(p0)]
    it = iter(live)
    p = tree_map(lambda _: next(it), p0)
    loss = sum(0.5 * t_tm.loss_fn(
        p, tcfg, {n: torch.from_numpy(x[c, 0]).long()
                  for n, x in batches.items()})[0] for c in range(2))
    grads = torch.autograd.grad(loss, live)
    for a, w, g in zip(leaves(new), live, grads):
        assert float((a - (w.detach() - 1e-2 * g)).abs().max()) <= 2e-5


# ---------------------------------------------------------------------------
# The trainer loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("algorithm", ["csmaafl", "fedavg"])
def test_run_spmd_matches_reference_loop(monkeypatch, algorithm):
    """The reference's ``main`` (spmd data plane, 1×1 host mesh) against
    ``run_spmd`` from the same initial parameters: every step's
    coefficient vector equal, final parameters ≤1e-5·(1+max)."""
    seen = {"coefs": []}
    make = j_dist.make_csmaafl_step

    def recording(*a, **kw):
        fn = make(*a, **kw)

        def step(params, batches, coefs, lr):
            seen.setdefault("params0", jax.tree.map(np.asarray, params))
            seen["coefs"].append(np.asarray(coefs))
            out = fn(params, batches, coefs, lr)
            seen["final"] = jax.tree.map(np.asarray, out[0])
            return out
        return step

    monkeypatch.setattr(j_train.dist, "make_csmaafl_step", recording)
    steps, seq = 3, 16
    j_train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", str(steps),
                  "--seq", str(seq), "--algorithm", algorithm])
    tcfg = t_base.get_config("qwen2-0.5b").reduced()
    run = t_train.run_spmd(
        tcfg, steps=steps, algorithm=algorithm, seq=seq,
        params=t_tm.params_from_jax(seen["params0"], tcfg, "cpu"),
        device="cpu")
    assert len(run.coefs) == steps == len(seen["coefs"])
    for a, b in zip(run.coefs, seen["coefs"]):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(run.losses))
    _assert_trees_close(t_tm.params_to_numpy(run.params, tcfg),
                        seen["final"])


def test_main_runs_on_cpu(capsys):
    run = t_train.main(["--reduced", "--steps", "2", "--seq", "8",
                        "--algorithm", "fedavg"], device="cpu")
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    assert "step    1" in capsys.readouterr().out
    for c in run.coefs:
        assert c[0] == 0.0 and abs(float(c.sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("flags,item", [
    (["--data-plane", "fleet"], "#13f"),
    (["--window-cap", "8"], "#13f"),
    (["--sweep", "grid.json"], "#9"),
    (["--loop", "compiled"], "#6"),
    (["--resume"], "#7"),
    (["--autosave", "4"], "#7"),
    (["--guards", "default"], "#7"),
    (["--faults", "lossy"], "#7"),
    (["--save", "model.ckpt"], "#7"),
    (["--config", "run.json"], "#8"),
    (["--mesh", "single"], "#14"),
    (["--mesh", "multi"], "#14"),
])
def test_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        t_train.main(["--reduced", "--steps", "1"] + flags, device="cpu")


def test_entry_points_need_the_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tcfg = t_base.get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_dist.make_csmaafl_step(tcfg, t_base.FederatedConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.run_spmd(tcfg, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.main(["--reduced", "--steps", "1"])
    step = t_dist.make_csmaafl_step(tcfg, t_base.FederatedConfig(),
                                    device="cpu")
    assert callable(step)
