"""The port on the card: the CUDA kernels against their plain versions,
the engine, and the slices' CPU-vs-card parity.

This file imports neither jax nor ``repro``, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Every test here needs a CUDA card and nvcc; it decides so in a fixture
and skips without them.  Tolerances: f32 1e-6·(1+max|ref|) (summation
order and FMA only), bf16 one bf16 ulp on top of that; runs ≤1e-5 on
the parameters.  Flash attention: the reference's f32 FA bound
2e-5·(1+max|ref|), bf16 one bf16 ulp on top of it (both sides compute
in f32 and round once), the f32 log-sum-exp 2e-5·(1+max|lse|);
reduced qwen2-0.5b prefill + decode CPU vs card ≤1e-5·(1+max|ref|).
SSD scan: the kernel against the plain chunked op and the sequential
recurrence 2e-5·(1+max|ref|) (bf16 inputs: one bf16 ulp on top), two
launches bitwise equal; reduced mamba2-780m prefill + decode CPU vs card
≤1e-5·(1+max|ref|), tokens equal.
Flash backward: the dQ and dK/dV kernels against the plain backward at
the forward's bounds, and two launches bitwise equal; reduced qwen2-0.5b
fused steps CPU vs card ≤1e-5·(1+max|ref|) per parameter leaf and per
gradient leaf.  Every kernel, launched into an output between NaN
guards, writes all of its output and nothing outside it.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch._tree import leaves, tree_map
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.agg_engine import AggEngine
from repro_torch.core.scheduler import make_fleet
from repro_torch.core.tasks import CNNTask
from repro_torch.configs.base import FederatedConfig, get_config
from repro_torch.core import distributed as dist
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_scan as ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_sequential
from repro_torch.kernels.weighted_agg import weighted_agg as wa
from repro_torch.kernels.weighted_agg.ref import weighted_agg_ref
from repro_torch.models import cnn
from repro_torch.models import transformer as tmod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    return torch.device("cuda")


def _assert_close(out, ref, rel=1e-6):
    diff = (out.float() - ref.float()).abs()
    tol = rel * (1.0 + float(ref.float().abs().max()))
    if out.dtype == torch.bfloat16:
        # one bf16 ulp of the result on top of the f32 bound (cancellation
        # can leave a result below the f32 accumulation error)
        mag = torch.maximum(out.float().abs(), ref.float().abs())
        _, e = torch.frexp(mag.clamp_min(2.0 ** -126))
        ulp = torch.ldexp(torch.ones_like(mag), e - 8)
        assert bool((diff <= ulp + tol).all())
    else:
        assert float(diff.max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,n,layout", [
    (1, 1_663_370, "padded"), (100, 1_663_370, "padded"),
    (4, 1_000_003, "contiguous"), (1, 7, "contiguous"),
    (3, 4099, "gather")])
def test_kernel_matches_plain(cuda, dtype, C, n, layout):
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(C + n)
    R = C + 2 if layout == "gather" else C
    width = n + 64 if layout == "padded" else n
    rows = torch.randn(R, width, generator=gen, device=cuda).to(tdt)[:, :n]
    g = torch.randn(n, generator=gen, device=cuda).to(tdt)
    coefs = torch.rand(C + 1, generator=gen, device=cuda) * 2 - 1
    cids = None
    if layout == "gather":
        cids = torch.tensor([R - 1, 0, 2], dtype=torch.int32, device=cuda)
    before = wa.weighted_agg_flat2d.launches
    out = wa.weighted_agg_flat2d(g, rows, coefs, cids)
    torch.cuda.synchronize()
    assert wa.weighted_agg_flat2d.launches == before + 1
    assert out.dtype == tdt and out.device == g.device
    _assert_close(out, weighted_agg_ref(g, rows, coefs, cids))


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda):
    """Kernel mode on the card == the CPU path; torch mode refuses CUDA."""
    rng = np.random.default_rng(0)
    tree = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for k, s in {"b": (5,), "a": (33, 17), "c": (257,)}.items()}
    eng = AggEngine(tree)
    g = eng.flatten(tree)
    rows = torch.from_numpy(rng.normal(size=(5, eng.n)).astype(np.float32))
    betas = [0.9, 0.5, 0.8, 0.7, 0.6]
    cpu = eng.blend_rows_flat(g, rows, betas)
    card = eng.blend_rows_flat(g.to(cuda), rows.to(cuda), betas)
    _assert_close(card.cpu(), cpu)
    fleet_cpu = eng.blend_rows_fleet(g, rows, [4, 0, 4], [0.5, 0.6, 0.7])
    fleet_card = eng.blend_rows_fleet(g.to(cuda), rows.to(cuda), [4, 0, 4],
                                      [0.5, 0.6, 0.7])
    _assert_close(fleet_card.cpu(), fleet_cpu)
    with pytest.raises(ValueError):
        AggEngine(tree, mode="torch").blend_rows_flat(
            g.to(cuda), rows.to(cuda), betas)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["fedavg", "csmaafl"])
def test_per_leaf_path_refuses_the_card(cuda, algorithm):
    """use_engine=False without a plane is the CPU oracle: on the card it
    raises instead of blending in plain torch."""
    cfg_cnn = CNNConfig(conv1=4, conv2=8, fc=32)
    task = CNNTask(device=cuda, iid=False, num_clients=5, train_n=600,
                   test_n=200, local_batches_per_step=1, cnn_cfg=cfg_cnn)
    cfg = api.RunConfig(algorithm=algorithm, iterations=2, use_engine=False,
                        plane=api.PlaneConfig(kind="none"),
                        fleet=api.FleetConfig(num_clients=5))
    before = wa.weighted_agg_flat2d.launches
    with pytest.raises(ValueError, match="CPU tensors only"):
        api.run(task, cfg)
    assert wa.weighted_agg_flat2d.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm,iterations",
                         [("fedavg", 2), ("csmaafl", 30),
                          ("afl_baseline", 10)])
def test_slice_on_card_matches_cpu(cuda, algorithm, iterations):
    """The same narrow-CNN run on the card (kernel) and on the CPU (plain
    version): one launch per accepted event / FedAvg round, same times,
    parameters ≤1e-5."""
    cfg_cnn = CNNConfig(conv1=4, conv2=8, fc=32)
    task_kw = dict(iid=False, num_clients=5, train_n=600, test_n=200,
                   local_batches_per_step=2, cnn_cfg=cfg_cnn)
    cfg = api.RunConfig(algorithm=algorithm, iterations=iterations,
                        eval_every=5, timing=api.TimingConfig(0.05, 0.05))
    p0 = cnn.init_params(cfg_cnn, torch.Generator().manual_seed(0))
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for dev in (torch.device("cpu"), cuda):
            task = CNNTask(device=dev, **task_kw)
            fleet = make_fleet(5, tau=1.0, hetero_a=8.0, seed=0,
                               samples_per_client=task.num_samples())
            before = wa.weighted_agg_flat2d.launches
            res = api.run(task, cfg, fleet=fleet, eval_fn=task.eval_fn,
                          params0={k: v.to(dev) for k, v in p0.items()})
            torch.cuda.synchronize()
            params, hist = res if algorithm == "fedavg" else \
                (res.params, res.history)
            out[dev.type] = (params, hist,
                             wa.weighted_agg_flat2d.launches - before)
    finally:
        torch.backends.cudnn.deterministic = False
    (cpu_p, cpu_h, cpu_n), (card_p, card_h, card_n) = out["cpu"], out["cuda"]
    assert cpu_n == 0 and card_n == iterations
    assert card_h.times == cpu_h.times
    eng = AggEngine(p0)
    diff = (eng.flatten(card_p).cpu() - eng.flatten(cpu_p)).abs().max()
    assert float(diff) <= 1e-5


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # B, H, Hkv, S, D, window, cap, dtype: the reference's FA_CASES, then
    # qwen2-0.5b's attention at S = 512 and a ragged 200, and head_dim 256
    (2, 4, 4, 128, 64, 0, 0.0, "float32"),
    (1, 8, 2, 256, 64, 0, 0.0, "float32"),
    (2, 4, 2, 200, 32, 64, 0.0, "float32"),
    (1, 4, 4, 128, 64, 0, 50.0, "float32"),
    (1, 2, 1, 512, 128, 128, 0.0, "float32"),
    (1, 4, 2, 256, 64, 0, 0.0, "bfloat16"),
    (1, 3, 1, 96, 16, 32, 30.0, "float32"),
    (4, 14, 2, 512, 64, 0, 0.0, "float32"),
    (4, 14, 2, 200, 64, 0, 0.0, "float32"),
    (4, 14, 2, 512, 64, 0, 0.0, "bfloat16"),
    (4, 14, 2, 200, 64, 0, 0.0, "bfloat16"),
    (1, 2, 2, 300, 256, 0, 0.0, "float32"),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,H,Hkv,S,D,win,cap,dtype,causal",
    [c + (True,) for c in FLASH_CASES]
    # full (non-causal) attention where no window is set
    + [c + (False,) for c in FLASH_CASES if not c[5]])
def test_flash_kernel_matches_plain(cuda, B, H, Hkv, S, D, win, cap, dtype,
                                    causal):
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(S * D + H)
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device=cuda).to(tdt)
               for h in (H, Hkv, Hkv))
    before = fa.flash_attention_fwd.launches
    out = flash_attention(q, k, v, causal=causal, window=win,
                          logit_cap=cap)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out2, lse = fa.flash_attention_fwd(qt, kt, vt, causal=causal,
                                       window=win, logit_cap=cap,
                                       return_lse=True)
    ref, ref_lse = attention_ref(qt, kt, vt, causal=causal, window=win,
                                 logit_cap=cap, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 2
    assert out.shape == q.shape and out.dtype == tdt and out.is_contiguous()
    for o in (out.transpose(1, 2), out2):
        _assert_close(o, ref, rel=2e-5)
    assert float((lse - ref_lse).abs().max()) <= \
        2e-5 * (1 + float(ref_lse.abs().max()))


@pytest.mark.gpu
def test_flash_raises_when_library_fails_to_load(cuda, monkeypatch):
    """No fall-back: a CUDA call whose library cannot load raises, and
    nothing is counted."""
    q = torch.randn(1, 64, 2, 64, device=cuda)

    def broken(name):
        raise OSError(f"cannot load {name}")

    fa._launch_fn.cache_clear()
    monkeypatch.setattr(_build, "library", broken)
    before = fa.flash_attention_fwd.launches
    try:
        with pytest.raises(OSError, match="flash_attention"):
            flash_attention(q, q, q)
    finally:
        fa._launch_fn.cache_clear()
    assert fa.flash_attention_fwd.launches == before
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :48], q[..., :48], q[..., :48])


@pytest.mark.gpu
def test_init_params_lands_on_the_card(cuda):
    """A CPU generator draws the parameters; they are placed on the card
    unless the caller asks for the CPU."""
    cfg = get_config("qwen2-0.5b").reduced()
    on_card = tmod.init_params(cfg, torch.Generator().manual_seed(0))
    on_cpu = tmod.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    for i, (a, b) in enumerate(zip(leaves(on_card), leaves(on_cpu))):
        assert a.device.type == "cuda" and b.device.type == "cpu"
        back = a.cpu()
        bad = back != b
        if bool(bad.any()):
            # say where and how much, and which side moved: a third CPU
            # draw, a second copy back, and the CPU draw's own round trip
            at = bad.reshape(-1).nonzero().reshape(-1)
            third = leaves(tmod.init_params(
                cfg, torch.Generator().manual_seed(0), device="cpu"))[i]
            # ATen's elementwise loops split a tensor into at most
            # get_num_threads() chunks of at least 32,768 elements
            threads = torch.get_num_threads()
            chunks = max(1, min(threads, -(-b.numel() // 32768)))
            pytest.fail(
                f"leaf {i} {tuple(b.shape)}: {at.numel()} of {b.numel()} "
                f"elements differ, flat indices {int(at[0])}..{int(at[-1])}"
                f", max |Δ| {float((back - b).abs().max())}; intra-op "
                f"threads {threads}, split into {chunks} chunks of "
                f"{-(-b.numel() // chunks)}; a third CPU "
                f"draw equals the card's: {torch.equal(third, back)}, the "
                f"CPU one: {torch.equal(third, b)}; a second copy back "
                f"equals the first: {torch.equal(a.cpu(), back)}; the CPU "
                f"draw survives a round trip to the card: "
                f"{torch.equal(b.to(cuda).cpu(), b)}")


@pytest.mark.gpu
def test_prefill_on_card_launches_and_matches_cpu(cuda):
    """Reduced qwen2-0.5b: the card's flash prefill launches the kernel
    once per layer (the naive one never), and prefill + 8 decode steps
    match the CPU run ≤1e-5·(1+max), tokens equal."""
    cfg = get_config("qwen2-0.5b").reduced()
    p_cpu = tmod.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
    runs = []
    for dev in (torch.device("cpu"), cuda):
        params = tree_map(lambda t: t.to(dev), p_cpu)
        cache = tmod.init_cache(cfg, 2, 48, dtype=torch.float32, device=dev)
        before = fa.flash_attention_fwd.launches
        logits, cache = tmod.prefill(params, cfg, {"tokens": tokens.to(dev)},
                                     cache, attn_impl="pallas")
        launches = fa.flash_attention_fwd.launches - before
        outs = [logits.cpu()]
        for step in range(8):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = tmod.decode_step(params, cfg, tok, cache,
                                             40 + step)
            outs.append(logits.cpu())
        runs.append((outs, tmod.caches_to_numpy(cache, cfg), launches))
    (c_out, c_cache, c_n), (g_out, g_cache, g_n) = runs
    assert c_n == 0 and g_n == cfg.num_layers
    for g, c in zip(g_out, c_out):
        assert float((g - c).abs().max()) <= 1e-5 * (1 + float(c.abs().max()))
        assert torch.equal(g.argmax(-1), c.argmax(-1))
    for gl, cl in zip(g_cache["dec"]["rem"], c_cache["dec"]["rem"]):
        assert np.array_equal(gl["slot_pos"], cl["slot_pos"])
        for name in ("k", "v"):
            assert np.abs(gl[name] - cl[name]).max() <= \
                1e-5 * (1 + np.abs(cl[name]).max())
    before = fa.flash_attention_fwd.launches
    tmod.prefill(tree_map(lambda t: t.to(cuda), p_cpu), cfg,
                 {"tokens": tokens.to(cuda)}, attn_impl="naive")
    assert fa.flash_attention_fwd.launches == before


# ---------------------------------------------------------------------------
# flash attention backward and the fused training step
# ---------------------------------------------------------------------------
FLASH_BWD_CASES = [
    # the reference's backward cases (tests/test_kernels.py), then
    # FLASH_CASES, qwen2-0.5b's training shape (B = 8) and a bf16 D = 128
    (1, 4, 2, 128, 32, 0, 0.0, "float32"),
    (1, 4, 2, 160, 32, 48, 0.0, "float32"),
    (1, 2, 1, 96, 16, 0, 30.0, "float32"),
    *FLASH_CASES,
    (8, 14, 2, 512, 64, 0, 0.0, "float32"),
    (1, 4, 2, 130, 128, 0, 0.0, "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,H,Hkv,S,D,win,cap,dtype,causal",
    [c + (True,) for c in FLASH_BWD_CASES]
    + [c + (False,) for c in FLASH_BWD_CASES[:6] if not c[5]])
def test_flash_bwd_kernels_match_plain(cuda, B, H, Hkv, S, D, win, cap,
                                       dtype, causal):
    """dQ and dK/dV against the plain backward on the same inputs, in the
    model's layout through strides; each gradient takes its input's
    layout; a second launch gives the same bits."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(S * D + H + 1)
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=cuda)
                   .to(tdt).transpose(1, 2) for h in (H, Hkv, Hkv, H))
    kw = dict(causal=causal, window=win, logit_cap=cap)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    before = (fa.flash_attention_bwd.launches_dq,
              fa.flash_attention_bwd.launches_dkv)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    ref = attention_bwd_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd.launches_dq,
            fa.flash_attention_bwd.launches_dkv) == \
        (before[0] + 2, before[1] + 2)
    for g, g2, r, x in zip(got, again, ref, (q, k, v)):
        assert g.dtype == tdt and g.stride() == x.stride()
        assert torch.equal(g, g2)
        _assert_close(g, r, rel=2e-5)


def _guarded(shape, dtype, device, model_layout=False):
    """An output of ``shape`` inside a NaN-filled buffer with a guard on
    each side of 64 times its last two dimensions (64 times a row of
    heads in the model layout) plus 64 elements: more than a whole
    64-row tile past either end.  A (B, H, S, D) output is stored as
    (B, S, H, D) when ``model_layout``.  Returns (view, buffer, guard
    length)."""
    n = int(np.prod(shape))
    pad = 64 * int(np.prod(shape[-2:] if not model_layout
                           else (shape[1], shape[3]))) + 64
    buf = torch.full((n + 2 * pad,), float("nan"), dtype=dtype,
                     device=device)
    block = buf[pad:pad + n]
    if model_layout:
        B, H, S, D = shape
        return block.view(B, S, H, D).transpose(1, 2), buf, pad
    return block.view(shape), buf, pad


def _assert_written_in_bounds(view, buf, pad):
    assert bool(buf[:pad].isnan().all()) and bool(buf[-pad:].isnan().all()), \
        "the kernel wrote outside its output"
    assert not bool(view.isnan().any()), \
        "the kernel left elements of its output unwritten"


@pytest.mark.gpu
@pytest.mark.parametrize("model_layout", [False, True])
@pytest.mark.parametrize("B,H,Hkv,S,D,win,cap,dtype", [
    (1, 4, 2, 160, 32, 48, 0.0, "float32"),
    (1, 3, 1, 96, 16, 32, 30.0, "float32"),
    (4, 14, 2, 200, 64, 0, 0.0, "float32"),
    (4, 14, 2, 200, 64, 0, 0.0, "bfloat16"),
    (2, 2, 1, 65, 64, 0, 0.0, "float32"),
    (1, 2, 2, 1, 64, 0, 0.0, "float32"),
    (1, 2, 2, 300, 256, 0, 0.0, "float32"),
    (1, 4, 2, 130, 128, 0, 0.0, "bfloat16")])
def test_flash_kernels_write_only_their_outputs(cuda, B, H, Hkv, S, D, win,
                                                cap, dtype, model_layout):
    """The forward, dQ and dK/dV kernels, launched into outputs that sit
    between NaN guards of a whole tile of rows, at ragged lengths: no
    guard element changes, every output element is written, the inputs
    are left as they were, and the results equal the wrappers' bits."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(S * D + H + 2)
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=cuda)
                   .to(tdt).transpose(1, 2) for h in (H, Hkv, Hkv, H))
    kw = dict(causal=True, window=win, logit_cap=cap)
    scale = 1.0 / D ** 0.5
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    inputs = [t.clone() for t in (q, k, v, do, out, lse, delta)]

    o_g, o_buf, o_pad = _guarded(q.shape, tdt, cuda, model_layout)
    l_g, l_buf, l_pad = _guarded(lse.shape, torch.float32, cuda)
    fa._fwd_launch(q, k, v, o_g, l_g, True, win, scale, cap)
    q_g, q_buf, q_pad = _guarded(q.shape, tdt, cuda, model_layout)
    fa._bwd_launch("dq", q, k, v, do, lse, delta, [q_g], True, win, scale,
                   cap)
    k_g, k_buf, k_pad = _guarded(k.shape, tdt, cuda, model_layout)
    v_g, v_buf, v_pad = _guarded(k.shape, tdt, cuda, model_layout)
    fa._bwd_launch("dkv", q, k, v, do, lse, delta, [k_g, v_g], True, win,
                   scale, cap)
    torch.cuda.synchronize()
    for view, buf, pad, want in ((o_g, o_buf, o_pad, out),
                                 (l_g, l_buf, l_pad, lse),
                                 (q_g, q_buf, q_pad, dq),
                                 (k_g, k_buf, k_pad, dk),
                                 (v_g, v_buf, v_pad, dv)):
        _assert_written_in_bounds(view, buf, pad)
        assert torch.equal(view, want)
    for t, before in zip((q, k, v, do, out, lse, delta), inputs):
        assert torch.equal(t, before)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,shift", [(1_000_003, 0), (4099, 1), (7, 3)])
def test_weighted_agg_writes_only_its_output(cuda, dtype, n, shift):
    """The weighted-aggregation kernel launched into an output between
    NaN guards (16-byte aligned, so vectorised, or shifted off it, so
    scalar): no guard element changes and every element is written."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(n + shift)
    width = (n + 7) // 8 * 8            # 16-byte aligned row stride
    rows = torch.randn(3, width, generator=gen, device=cuda).to(tdt)[:, :n]
    g = torch.randn(n, generator=gen, device=cuda).to(tdt)
    coefs = torch.rand(4, generator=gen, device=cuda)
    buf = torch.full((n + 2 * 4096 + shift,), float("nan"), dtype=tdt,
                     device=cuda)
    view = buf[4096 + shift:4096 + shift + n]
    assert wa.vectorizable(g, rows, view) == (shift == 0)
    wa._launch(g, rows, coefs, None, 3, view)
    torch.cuda.synchronize()
    assert bool(buf[:4096 + shift].isnan().all())
    assert bool(buf[4096 + shift + n:].isnan().all())
    assert not bool(view.isnan().any())
    _assert_close(view, weighted_agg_ref(g, rows, coefs))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,D,win,cap,dtype",
                         [FLASH_BWD_CASES[i] for i in (0, 1, 2, 8, 13)])
def test_flash_autograd_on_card_matches_plain(cuda, B, H, Hkv, S, D, win,
                                              cap, dtype):
    """Autograd through ``ops.flash_attention`` (forward and both backward
    kernels) against the plain backward fed the forward kernel's (out,
    lse): the forward is deterministic, and in bf16 a plain forward's
    output may differ by one ulp, which δ would carry into every
    gradient."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=cuda)
                   .to(tdt) for h in (H, Hkv, Hkv, H))
    kw = dict(causal=True, window=win, logit_cap=cap)
    inputs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = fa.flash_attention_bwd.launches_dq
    flash_attention(*inputs, **kw).backward(do)
    assert fa.flash_attention_bwd.launches_dq == before + 1
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse = fa.flash_attention_fwd(qt, kt, vt, return_lse=True, **kw)
    for x, r in zip(inputs, attention_bwd_ref(qt, kt, vt, out, lse, dot,
                                              **kw)):
        _assert_close(x.grad.transpose(1, 2), r, rel=2e-5)


@pytest.mark.gpu
def test_flash_wrappers_build_no_graph_on_the_card(cuda):
    """Called directly with an input that requires grad, in grad mode, the
    forward and backward wrappers raise on the card as on the CPU, and
    launch nothing; ``ops.flash_attention`` is the differentiable path."""
    q = torch.randn(1, 2, 64, 64, device=cuda)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, q, q, return_lse=True)
    r = q.clone().requires_grad_(True)
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd.launches_dq,
              fa.flash_attention_bwd.launches_dkv)
    with pytest.raises(RuntimeError, match="ops.flash_attention"):
        fa.flash_attention_fwd(r, q, q)
    with pytest.raises(RuntimeError, match="ops.flash_attention"):
        fa.flash_attention_bwd(r, q, q, out, lse, q)
    delta = (q * out).sum(-1).contiguous()
    with pytest.raises(RuntimeError, match="ops.flash_attention"):
        fa.flash_attention_bwd_dq(r, q, q, q, lse, delta)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches_dq,
            fa.flash_attention_bwd.launches_dkv) == before


@pytest.mark.gpu
def test_flash_bwd_raises_when_library_fails_to_load(cuda, monkeypatch):
    """No fall-back: a CUDA backward whose library cannot load raises,
    and nothing is counted."""
    q = torch.randn(1, 2, 64, 64, device=cuda)
    out, lse = fa.flash_attention_fwd(q, q, q, return_lse=True)

    def broken(name):
        raise OSError(f"cannot load {name}")

    fa._bwd_launch_fns.cache_clear()
    monkeypatch.setattr(_build, "library", broken)
    before = (fa.flash_attention_bwd.launches_dq,
              fa.flash_attention_bwd.launches_dkv)
    try:
        with pytest.raises(OSError, match="flash_attention_bwd"):
            fa.flash_attention_bwd(q, q, q, out, lse, q)
    finally:
        fa._bwd_launch_fns.cache_clear()
    assert (fa.flash_attention_bwd.launches_dq,
            fa.flash_attention_bwd.launches_dkv) == before


@pytest.mark.gpu
@pytest.mark.parametrize("C,K,rows,M,coefs", [
    (3, 1, 2, 1, [0.2, 0.5, 0.2, 0.1]),
    (2, 1, 4, 2, [0.1, 0.6, 0.3]),
    (2, 2, 2, 1, [0.4, 0.3, 0.3])])
def test_fused_step_on_card_matches_cpu(cuda, C, K, rows, M, coefs):
    """Reduced qwen2-0.5b through the fused step with the flash kernels:
    the card's updated parameters match the CPU's (plain versions)
    ≤1e-5·(1+max) per leaf; per gradient one launch of each flash kernel
    per layer, and on the K=2 path one weighted_agg launch per leaf."""
    cfg = get_config("qwen2-0.5b").reduced()
    p_cpu = tmod.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(C + K + M)
    batches = {n: rng.integers(0, cfg.vocab_size, (C, K, rows, 40))
               .astype(np.int32) for n in ("tokens", "labels")}
    fed = FederatedConfig(local_steps=K, grad_accum=M)
    res = {}
    for dev in (torch.device("cpu"), cuda):
        step = dist.make_csmaafl_step(cfg, fed, attn_impl="pallas",
                                      device=dev)
        before = (fa.flash_attention_bwd.launches_dkv,
                  wa.weighted_agg_flat2d.launches)
        new, _ = step(tree_map(lambda t: t.to(dev), p_cpu), batches,
                      coefs, 1e-2)
        torch.cuda.synchronize()
        res[dev.type] = (new, fa.flash_attention_bwd.launches_dkv
                         - before[0],
                         wa.weighted_agg_flat2d.launches - before[1])
    (c_new, c_n, c_agg), (g_new, g_n, g_agg) = res["cpu"], res["cuda"]
    grads = C * K if K > 1 else M
    assert (c_n, c_agg) == (0, 0)
    assert g_n == cfg.num_layers * grads
    assert g_agg == (len(leaves(p_cpu)) if K > 1 else 0)
    for a, b in zip(leaves(g_new), leaves(c_new)):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-5 * (1 + float(b.abs().max()))
    # the step's gradients themselves: lr·g in the update would hide a
    # gradient error under the parameters' rounding
    g = {}
    for dev in (torch.device("cpu"), cuda):
        p = tree_map(lambda t: t.to(dev), p_cpu)
        b = {n: torch.as_tensor(x, device=dev, dtype=torch.int64)
             for n, x in batches.items()}
        if K == 1:
            cc = torch.tensor(coefs[1:], dtype=torch.float32, device=dev)
            g[dev.type] = [dist.fused_value_and_grad(
                p, b, cc, cfg=cfg, fed=fed, attn_impl="pallas")[1]]
        else:
            g[dev.type] = [dist._value_and_grad(
                p, cfg, {n: x[c, 0] for n, x in b.items()}, "pallas")[1]
                for c in range(C)]
    for a, b in zip(leaves(g["cuda"]), leaves(g["cpu"])):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-5 * (1 + float(b.abs().max()))


# ---------------------------------------------------------------------------
# the SSD chunk scan and Mamba2 serving
# ---------------------------------------------------------------------------
SSD_CASES = [
    # Bt, L, H, P, G, N, chunk: the reference's SSD_CASES
    # (tests/test_kernels.py), one row of mamba2-780m's heads at L = 128
    # and zamba2's grouping (G = 2, N = 64)
    (2, 128, 4, 64, 1, 32, 32),
    (1, 256, 8, 64, 2, 64, 64),
    (2, 64, 4, 32, 4, 16, 16),
    (1, 128, 6, 64, 3, 128, 128),
    (1, 128, 48, 64, 1, 128, 128),
    (2, 256, 8, 64, 2, 64, 128),
]


def _ssd_inputs(Bt, L, H, P, G, N, dtype, device, seed):
    """x, dt, A, B, C on the card: dt = softplus(normal)·0.1 and
    A = −exp(0.3·normal), as the reference's kernel tests draw them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = rnd(Bt, L, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rnd(Bt, L, H)) * 0.1
    A = -torch.exp(rnd(H) * 0.3)
    return x, dt, A, rnd(Bt, L, G, N).to(dtype), rnd(Bt, L, G, N).to(dtype)


def _assert_ssd_close(out, ref, bf16):
    """2e-5·(1+max|ref|); with bf16 inputs one bf16 ulp of the result on
    top (both sides read the same bf16 values and compute in f32)."""
    diff = (out - ref).abs()
    tol = 2e-5 * (1.0 + float(ref.abs().max()))
    if bf16:
        mag = torch.maximum(out.abs(), ref.abs())
        _, e = torch.frexp(mag.clamp_min(2.0 ** -126))
        tol = torch.ldexp(torch.ones_like(mag), e - 8) + tol
        assert bool((diff <= tol).all())
    else:
        assert float(diff.max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bt,L,H,P,G,N,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, Bt, L, H, P, G, N, chunk, dtype):
    """The kernel against the plain chunked op and the sequential
    recurrence on the same inputs; a second launch gives the same bits."""
    args = _ssd_inputs(Bt, L, H, P, G, N, getattr(torch, dtype), cuda,
                       L + H + N)
    before = ssd.ssd_scan_fwd.launches
    y, s = ssd.ssd_scan_fwd(*args, chunk=chunk)
    y2, s2 = ssd.ssd_scan_fwd(*args, chunk=chunk)
    plain = ssd_chunked(*args, chunk=chunk)
    seq = ssd_sequential(*args)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_fwd.launches == before + 2
    assert y.shape == (Bt, L, H, P) and s.shape == (Bt, H, P, N)
    assert y.dtype == s.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(s, s2)
    for ry, rs in (plain, seq):
        _assert_ssd_close(y, ry, dtype == "bfloat16")
        _assert_ssd_close(s, rs, dtype == "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("Bt,L,H,G,N,chunk", [(3, 96, 5, 1, 32, 32),
                                              (1, 64, 6, 3, 128, 64),
                                              (3, 128, 5, 5, 16, 128)])
def test_ssd_kernel_writes_only_its_outputs(cuda, Bt, L, H, G, N, chunk):
    """The kernel launched into y (in a (Bt, L, H, P) layout padded along
    the heads) and a state that sit between NaN guards of a whole chunk
    of rows, from non-contiguous inputs (x, B and C column slices of one
    buffer, as the model's conv output, dt a transposed view): no guard
    element changes, every output element is written, the inputs are
    left as they were, and the results equal the wrapper's bits."""
    P = 64
    gen = torch.Generator(device=cuda).manual_seed(Bt * L + H)
    buf = torch.randn(Bt, L, H * P + 2 * G * N + 7, generator=gen,
                      device=cuda)
    x = buf[..., :H * P].view(Bt, L, H, P)
    Bm = buf[..., H * P:H * P + G * N].view(Bt, L, G, N)
    Cm = buf[..., H * P + G * N:H * P + 2 * G * N].view(Bt, L, G, N)
    dt = (torch.rand(Bt, H, L, generator=gen, device=cuda) * 0.1
          ).transpose(1, 2)
    A = -torch.rand(H, generator=gen, device=cuda) - 0.5
    assert not x.is_contiguous() and dt.stride(2) != 1
    want_y, want_s = ssd.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    inputs = [t.clone() for t in (buf, dt, A)]
    pad = chunk * (H + 1) * P + 64
    y_buf = torch.full((2 * pad + Bt * L * (H + 1) * P,), float("nan"),
                       device=cuda)
    y = y_buf[pad:pad + Bt * L * (H + 1) * P].view(Bt, L, H + 1, P)[:, :, :H]
    s_pad = P * N + 64
    s_buf = torch.full((2 * s_pad + Bt * H * P * N,), float("nan"),
                       device=cuda)
    s = s_buf[s_pad:s_pad + Bt * H * P * N].view(Bt, H, P, N)
    ssd._launch(x, dt, A, Bm, Cm, y, s, chunk)
    torch.cuda.synchronize()
    assert bool(y_buf[:pad].isnan().all()) and \
        bool(y_buf[-pad:].isnan().all()), "the kernel wrote outside y"
    assert bool(y_buf[pad:-pad].view(Bt, L, H + 1, P)[:, :, H].isnan()
                .all()), "the kernel wrote into y's padding"
    _assert_written_in_bounds(s, s_buf, s_pad)
    assert not bool(y.isnan().any()), "the kernel left y unwritten"
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    for t, before in zip((buf, dt, A), inputs):
        assert torch.equal(t, before)


@pytest.mark.gpu
def test_ssd_raises_on_the_card(cuda):
    """No graph, no fall-back: a requires-grad input raises, a library
    that cannot load raises, an unbuilt shape raises, nothing counted;
    ``ops.ssd`` is the differentiable path (kernel forward, plain
    backward)."""
    args = _ssd_inputs(1, 64, 4, 32, 2, 16, torch.float32, cuda, 0)
    r = args[0].clone().requires_grad_(True)
    before = ssd.ssd_scan_fwd.launches
    with pytest.raises(RuntimeError, match="ops.ssd"):
        ssd.ssd_scan_fwd(r, *args[1:], chunk=32)
    with pytest.raises(ValueError, match="built for chunk in"):
        ssd.ssd_scan_fwd(*args, chunk=8)
    assert ssd.ssd_scan_fwd.launches == before
    y, s = ssd_ops.ssd(r, *args[1:], chunk=32)
    (y.sum() + s.sum()).backward()
    assert ssd.ssd_scan_fwd.launches == before + 1
    leaf = args[0].clone().requires_grad_(True)
    yp, sp = ssd_chunked(leaf, *args[1:], chunk=32)
    (yp.sum() + sp.sum()).backward()
    _assert_ssd_close(r.grad, leaf.grad, False)


@pytest.mark.gpu
def test_ssd_raises_when_library_fails_to_load(cuda, monkeypatch):
    args = _ssd_inputs(1, 64, 4, 32, 2, 16, torch.float32, cuda, 0)

    def broken(name):
        raise OSError(f"cannot load {name}")

    ssd._launch_fn.cache_clear()
    monkeypatch.setattr(_build, "library", broken)
    before = ssd.ssd_scan_fwd.launches
    try:
        with pytest.raises(OSError, match="ssd_scan"):
            ssd.ssd_scan_fwd(*args, chunk=32)
    finally:
        ssd._launch_fn.cache_clear()
    assert ssd.ssd_scan_fwd.launches == before


@pytest.mark.gpu
def test_mamba2_prefill_on_card_launches_and_matches_cpu(cuda):
    """Reduced mamba2-780m (norm scales, conv bias and D off their init
    values): the card's prefill launches the SSD kernel once per layer,
    and prefill + 8 decode steps match the CPU run ≤1e-5·(1+max) on
    logits and caches, tokens equal."""
    cfg = get_config("mamba2-780m").reduced()
    p_cpu = tmod.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    gen = torch.Generator().manual_seed(1)
    for layer in p_cpu["stack"]["layers"]:
        for t in (layer["norm"]["scale"], layer["mixer"]["norm_scale"],
                  layer["mixer"]["conv_b"], layer["mixer"]["D"]):
            t.add_(0.1 * torch.randn(t.shape, generator=gen))
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 45)))
    runs = []
    for dev in (torch.device("cpu"), cuda):
        params = tree_map(lambda t: t.to(dev), p_cpu)
        cache = tmod.init_cache(cfg, 3, 53, dtype=torch.float32, device=dev)
        before = ssd.ssd_scan_fwd.launches
        logits, cache = tmod.prefill(params, cfg, {"tokens": tokens.to(dev)},
                                     cache)
        launches = ssd.ssd_scan_fwd.launches - before
        outs = [logits.cpu()]
        for step in range(8):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = tmod.decode_step(params, cfg, tok, cache,
                                             45 + step)
            outs.append(logits.cpu())
        runs.append((outs, tmod.caches_to_numpy(cache, cfg), launches))
    (c_out, c_cache, c_n), (g_out, g_cache, g_n) = runs
    assert c_n == 0 and g_n == cfg.num_layers
    for g, c in zip(g_out, c_out):
        assert float((g - c).abs().max()) <= 1e-5 * (1 + float(c.abs().max()))
        assert torch.equal(g.argmax(-1), c.argmax(-1))
    for gl, cl in zip(g_cache["dec"]["rem"], c_cache["dec"]["rem"]):
        for name in ("conv", "ssm"):
            assert np.abs(gl[name] - cl[name]).max() <= \
                1e-5 * (1 + np.abs(cl[name]).max())
