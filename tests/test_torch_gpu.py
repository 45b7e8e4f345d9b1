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
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.agg_engine import AggEngine
from repro_torch.core.scheduler import make_fleet
from repro_torch.core.tasks import CNNTask
from repro_torch.configs.base import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
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
    for a, b in zip(tmod._leaves(on_card), tmod._leaves(on_cpu)):
        assert a.device.type == "cuda" and b.device.type == "cpu"
        assert torch.equal(a.cpu(), b)


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
        params = tmod.tree_map(lambda t: t.to(dev), p_cpu)
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
    tmod.prefill(tmod.tree_map(lambda t: t.to(cuda), p_cpu), cfg,
                 {"tokens": tokens.to(cuda)}, attn_impl="naive")
    assert fa.flash_attention_fwd.launches == before
