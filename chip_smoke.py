#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Four main paths: federated learning (CSMAAFL and its baselines on the
paper's CNN, every server blend through the weighted-aggregation kernel),
LM serving (qwen2-0.5b at full width, every prefill attention through the
flash-attention kernel), Mamba2 serving (mamba2-780m at full width, every
prefill SSD through the SSD chunk-scan kernel) and federated LM training
(CSMAAFL and FedAvg on qwen2-0.5b at full width through the fused step,
attention forward and backward through the flash kernels, the K=2 blend
through the weighted-aggregation kernel).  Phases, one JSON line each:

1.  device   — card name and count, ``nvidia-smi`` name and power limit;
2.  build    — nvcc builds every kernel from the sources in this checkout
               (all at once), with ptxas registers and spills;
3.  kernel   — weighted_agg against its plain PyTorch version on the
               card, at the main path's shapes and at a ragged one;
4.  flash    — flash_attention_fwd against its plain version (output and
               log-sum-exp), f32 and bf16, window, softcap, GQA, ragged S;
4b. flash_bwd — the dQ and dK/dV kernels against the plain backward, two
               launches bitwise equal, and autograd through
               ``ops.flash_attention`` against the plain backward;
4c. ssd      — ssd_scan_fwd against the plain chunked op and the
               sequential recurrence, f32 and bf16 inputs, the reference's
               SSD_CASES, mamba2-780m's prefill shape and one row of it,
               zamba2's grouping; two launches bitwise equal;
5.  reduced  — a narrow-CNN CSMAAFL run on the CPU (plain version) and on
               the card (kernel): final parameters ≤1e-5, times equal;
6.  reduced_serve — reduced qwen2-0.5b prefill + 8 decode steps on the
               CPU and on the card: logits and caches ≤1e-5, tokens equal;
6b. reduced_train — reduced qwen2-0.5b fused steps (K=1, grad_accum=2,
               K=2) on the CPU and on the card: parameters and the
               steps' gradients ≤1e-5·(1+max) per leaf;
6c. reduced_serve_mamba2 — reduced mamba2-780m prefill + 8 decode steps
               on the CPU and on the card: logits and caches ≤1e-5·(1+max),
               tokens equal;
7.  main     — the AFL main path at the paper CNN's full width, M = 100:
               FedAvg, CSMAAFL and the §III-B baseline through ``api.run``;
8.  serve    — the serving main path at qwen2-0.5b's full width: prefill
               of 4 × 512 tokens (one flash launch per layer), 32 decode
               steps, ``BatchedServer`` over 8 requests; then the same
               prefill through the naive path for comparison;
8c. serve_mamba2 — the Mamba2 serving main path at mamba2-780m's full
               width: prefill of 4 × 512 tokens (one SSD launch per
               layer), 32 decode steps, ``BatchedServer`` over 8 requests
               (one SSD launch per layer and request), no call of the plain
               SSD; then a 512-token prefill against a 511-token prefill
               and one decode step (last logits ≤1e-4·(1+max));
8b. train    — the training main path at qwen2-0.5b's full width,
               ``run_spmd`` with C = 4 clients × 2 rows × 512 tokens: 8
               CSMAAFL steps, 2 FedAvg steps, 1 step with K = 2 local
               steps; then one step through the naive attention
               (loss, parameters and gradients ≤1e-5·(1+max));
9.  timing   — each kernel, its plain version and the one PyTorch call
               computing the same function, timed with CUDA events;
10. profile  — device busy share and device time by kernel over a short
               CSMAAFL run, full-width qwen2 and mamba2 prefill + decode and
               a full-width train step.

Each main path's launch counts are set to 0 just before it and read just
after.  Then the ``{"kernels": [...]}`` line and, last, the
``{"ok": true, ...}`` line.  Any failed check raises: the script exits
non-zero and prints no result, as it does when no CUDA card is present
or the port is missing.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_CNN = 1_663_370              # flat parameters of the paper's MNIST CNN
N_QWEN_EMBED = 151_936 * 896   # qwen2-0.5b's (tied) embedding leaf
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/weighted_agg/csrc/weighted_agg.cu"
KERNEL_REPLACES = "src/repro/kernels/weighted_agg/weighted_agg.py:106"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:100"
# B, H, Hkv, S, D, window, softcap, dtype: the reference's FA_CASES
# (tests/test_kernels.py) and qwen2-0.5b's attention (14 heads over 2 kv
# heads, head_dim 64) at S = 512 and at a ragged S = 200
FLASH_CASES = [
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
]
SERVE_B, SERVE_S, SERVE_STEPS = 4, 512, 32
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:81"
# Bt, L, H, P, G, N, chunk: the reference's SSD_CASES (tests/test_kernels.py),
# mamba2-780m's prefill shape (4 x 512, 48 heads of P = 64, one group of
# N = 128, chunk 128), one row of it at L = 128, and zamba2's grouping
# (G = 2, N = 64); each with f32 and with bf16 x, B, C
SSD_PREFILL = (SERVE_B, SERVE_S, 48, 64, 1, 128, 128)
SSD_CASES = [
    (2, 128, 4, 64, 1, 32, 32),
    (1, 256, 8, 64, 2, 64, 64),
    (2, 64, 4, 32, 4, 16, 16),
    (1, 128, 6, 64, 3, 128, 128),
    SSD_PREFILL,
    (1, 128, 48, 64, 1, 128, 128),
    (2, 256, 16, 64, 2, 64, 128),
]
FLASH_BWD_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_bwd.cu")
FLASH_DQ_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:325"
FLASH_DKV_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:355"
# the training main path: C clients x b rows x S tokens a step
TRAIN_C, TRAIN_ROWS, TRAIN_S = 4, 2, 512
TRAIN_B = TRAIN_C * TRAIN_ROWS          # attention batch of a K=1 step
# B, H, Hkv, S, D, window, softcap, dtype: the reference's backward cases
# (tests/test_kernels.py), FLASH_CASES' reference part, qwen2-0.5b's heads
# at S = 128 and ragged 200, and the training shape (B = 8, S = 512) and
# its ragged S = 200, f32 and bf16
FLASH_BWD_CASES = [
    (1, 4, 2, 128, 32, 0, 0.0, "float32"),
    (1, 4, 2, 160, 32, 48, 0.0, "float32"),
    (1, 2, 1, 96, 16, 0, 30.0, "float32"),
    *FLASH_CASES[:7],
    (1, 14, 2, 128, 64, 0, 0.0, "float32"),
    (1, 14, 2, 200, 64, 0, 0.0, "float32"),
    (TRAIN_B, 14, 2, TRAIN_S, 64, 0, 0.0, "float32"),
    (TRAIN_B, 14, 2, TRAIN_S, 64, 0, 0.0, "bfloat16"),
    (TRAIN_B, 14, 2, 200, 64, 0, 0.0, "float32"),
    (TRAIN_B, 14, 2, 200, 64, 0, 0.0, "bfloat16"),
    (1, 2, 2, 300, 256, 0, 0.0, "float32"),
    (1, 4, 2, 130, 128, 0, 0.0, "bfloat16"),
]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases 3 and 4: each kernel against its plain version
# ---------------------------------------------------------------------------
def bf16_ulp(x):
    import torch
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)   # 2^(floor(log2|x|)-7)


def kernel_vs_plain(device):
    import torch

    from repro_torch.kernels.weighted_agg.ref import weighted_agg_ref
    from repro_torch.kernels.weighted_agg.weighted_agg import (
        vectorizable, weighted_agg_flat2d)

    gen = torch.Generator(device=device).manual_seed(0)
    worst = {}                  # (C, dtype) -> max |Δ|
    cases = []
    for n in (N_CNN, 1_000_003):
        for dtype in (torch.float32, torch.bfloat16):
            for C in (1, 4, 100):
                for gather in (False, True):
                    R = C + 3 if gather else C
                    # main-path width: rows at the plane's aligned stride;
                    # ragged width: contiguous rows, scalar path for C > 1
                    width = -(-n // 64) * 64 if n == N_CNN else n
                    rows = torch.randn(R, width, generator=gen,
                                       device=device).to(dtype)[:, :n]
                    g = torch.randn(n, generator=gen, device=device).to(dtype)
                    coefs = torch.rand(C + 1, generator=gen, device=device)
                    cids = None
                    if gather:
                        cids = torch.randint(0, R, (C,), generator=gen,
                                             device=device,
                                             dtype=torch.int32)
                    out = weighted_agg_flat2d(g, rows, coefs, cids)
                    ref = weighted_agg_ref(g, rows, coefs, cids)
                    torch.cuda.synchronize()
                    diff = (out.float() - ref.float()).abs()
                    err = float(diff.max())
                    # f32: summation order and FMA only.  bf16: one ulp of
                    # the result on top (cancellation can leave a result
                    # below the f32 accumulation error)
                    tol = 1e-6 * (1.0 + float(ref.float().abs().max()))
                    if dtype == torch.float32:
                        ok = err <= tol
                    else:
                        bound = bf16_ulp(torch.maximum(out.float().abs(),
                                                       ref.float().abs()))
                        ok = bool((diff <= bound + tol).all())
                    key = (C, str(dtype).replace("torch.", ""))
                    worst[key] = max(worst.get(key, 0.0), err)
                    cases.append({"n": n, "C": C, "dtype": key[1],
                                  "gather": gather, "max_abs_err": err,
                                  "vector": vectorizable(g, rows, out),
                                  "ok": ok})
                    check(ok, f"kernel disagrees with plain: {cases[-1]}")
    return cases, worst


def flash_vs_plain(device):
    """flash_attention_fwd against attention_ref on the card, on the
    model's (B, S, H, D) layout read through strides.  Tolerances: the
    reference's f32 FA bound 2e-5·(1+max|ref|); bf16 one bf16 ulp of
    max(|out|, |ref|) on top of it, elementwise (both sides compute in f32
    and round the output once); the f32 log-sum-exp 2e-5·(1+max|lse|)."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=device).manual_seed(2)
    worst, cases = {}, []
    for B, H, Hkv, S, D, win, cap, dtype in FLASH_CASES:
        tdt = getattr(torch, dtype)
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=device)
                   .to(tdt).transpose(1, 2) for h in (H, Hkv, Hkv))
        kw = dict(causal=True, window=win, logit_cap=cap, return_lse=True)
        out, lse = flash_attention_fwd(q, k, v, **kw)
        ref, ref_lse = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        lse_err = float((lse - ref_lse).abs().max())
        tol = 2e-5 * (1.0 + float(ref.float().abs().max()))
        if dtype == "bfloat16":
            tol = bf16_ulp(torch.maximum(out.float().abs(),
                                         ref.float().abs())) + tol
        lse_tol = 2e-5 * (1.0 + float(ref_lse.abs().max()))
        case = {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D, "window": win,
                "cap": cap, "dtype": dtype, "max_abs_err": err,
                "tol": float(tol.max()) if torch.is_tensor(tol) else tol,
                "lse_err": lse_err, "lse_tol": lse_tol,
                "ok": bool((diff <= tol).all()) and lse_err <= lse_tol}
        cases.append(case)
        check(case["ok"], f"flash kernel disagrees with plain: {case}")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
    return cases, worst


def _grad_close(out, ref, dtype):
    """(max |Δ|, ok) under the flash bound: 2e-5·(1+max|ref|), bf16 one
    bf16 ulp of max(|out|, |ref|) on top, elementwise."""
    import torch

    diff = (out.float() - ref.float()).abs()
    tol = 2e-5 * (1.0 + float(ref.float().abs().max()))
    if dtype == "bfloat16":
        tol = bf16_ulp(torch.maximum(out.float().abs(),
                                     ref.float().abs())) + tol
    return float(diff.max()), bool((diff <= tol).all())


def flash_bwd_vs_plain(device):
    """The dQ and dK/dV kernels (``flash_attention_bwd``) against the plain
    backward ``attention_bwd_ref`` on the same (q, k, v, out, lse, dout),
    in the model's (B, S, H, D) layout read through strides; a second
    launch on the same inputs must give the same bits, and each gradient
    takes its input's layout.  Then autograd through ``ops.flash_attention``
    (the forward and both backward kernels behind a
    ``torch.autograd.Function``) against the same plain backward: the
    forward kernel is deterministic, so both are fed the same (out, lse)
    (in bf16 the plain forward's output may differ by one ulp, which δ
    would carry into every gradient)."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    gen = torch.Generator(device=device).manual_seed(4)
    worst, cases = {}, []
    for B, H, Hkv, S, D, win, cap, dtype in FLASH_BWD_CASES:
        tdt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=device)
                       .to(tdt) for h in (H, Hkv, Hkv, H))
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        kw = dict(causal=True, window=win, logit_cap=cap)
        out, lse = flash_attention_fwd(qt, kt, vt, return_lse=True, **kw)
        got = flash_attention_bwd(qt, kt, vt, out, lse, dot, **kw)
        again = flash_attention_bwd(qt, kt, vt, out, lse, dot, **kw)
        ref = attention_bwd_ref(qt, kt, vt, out, lse, dot, **kw)
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        ops.flash_attention(*leaves, **kw).backward(do)
        torch.cuda.synchronize()
        case = {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D, "window": win,
                "cap": cap, "dtype": dtype,
                "bitwise_repeat": all(torch.equal(a, b)
                                      for a, b in zip(got, again)),
                "layouts": all(g.stride() == x.stride()
                               for g, x in zip(got, (qt, kt, vt)))}
        ok = case["bitwise_repeat"] and case["layouts"]
        for name, g, r, x in zip(("dq", "dk", "dv"), got, ref, leaves):
            err, good = _grad_close(g, r, dtype)
            a_err, a_good = _grad_close(x.grad.transpose(1, 2), r, dtype)
            case[name], case[f"{name}_ok"] = err, good
            case[f"autograd_{name}"], case[f"autograd_{name}_ok"] = \
                a_err, a_good
            ok = ok and good and a_good
            key = f"{name}/{dtype}"
            worst[key] = max(worst.get(key, 0.0), err)
        case["ok"] = ok
        cases.append(case)
        check(ok, f"flash backward kernels disagree with plain: {case}")
    return cases, worst


def _ssd_inputs(case, dtype, gen, device):
    """x, dt, A, B, C for one SSD case on the card, drawn as the
    reference's kernel tests draw theirs: dt = softplus(normal)·0.1,
    A = −exp(0.3·normal); x, B, C in ``dtype``."""
    import torch
    import torch.nn.functional as F

    Bt, L, H, P, G, N, _ = case
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    x = rnd(Bt, L, H, P).to(dtype)
    dt = F.softplus(rnd(Bt, L, H)) * 0.1
    A = -torch.exp(rnd(H) * 0.3)
    return x, dt, A, rnd(Bt, L, G, N).to(dtype), rnd(Bt, L, G, N).to(dtype)


def ssd_vs_plain(device):
    """ssd_scan_fwd against the plain chunked op (``ssd_chunked``) and the
    exact sequential recurrence (``ssd_sequential``) on the same inputs,
    y and the final state.  Tolerance 2e-5·(1+max|ref|) (f32 on every
    side: only the order of the sums differs); with bf16 x, B, C one bf16
    ulp of max(|out|, |ref|) on top, elementwise (every side reads the
    same bf16 values).  A second launch on the same inputs must give the
    same bits."""
    import torch

    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_sequential
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd

    gen = torch.Generator(device=device).manual_seed(6)
    worst, cases = {}, []
    for case in SSD_CASES:
        for dtype in ("float32", "bfloat16"):
            args = _ssd_inputs(case, getattr(torch, dtype), gen, device)
            y, st = ssd_scan_fwd(*args, chunk=case[6])
            y2, st2 = ssd_scan_fwd(*args, chunk=case[6])
            refs = {"chunked": ssd_chunked(*args, chunk=case[6]),
                    "sequential": ssd_sequential(*args)}
            torch.cuda.synchronize()
            rec = {"case": list(case), "dtype": dtype,
                   "bitwise_repeat": torch.equal(y, y2)
                   and torch.equal(st, st2)}
            ok = rec["bitwise_repeat"]
            for name, (ry, rs) in refs.items():
                for part, out, ref in (("y", y, ry), ("state", st, rs)):
                    err, good = _grad_close(out, ref, dtype)
                    rec[f"{part}_vs_{name}"] = err
                    ok = ok and good
                    key = f"{part}/{dtype}"
                    if name == "chunked":
                        worst[key] = max(worst.get(key, 0.0), err)
            rec["ok"] = ok
            cases.append(rec)
            check(ok, f"SSD kernel disagrees with plain: {rec}")
    return cases, worst


# ---------------------------------------------------------------------------
# phases 5 and 7: runs through api.run
# ---------------------------------------------------------------------------
def reduced_cpu_vs_card(device):
    import torch

    from repro_torch import api
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.core.agg_engine import AggEngine
    from repro_torch.core.scheduler import make_fleet
    from repro_torch.core.tasks import CNNTask
    from repro_torch.kernels.weighted_agg import weighted_agg as wa
    from repro_torch.models import cnn

    cfg_cnn = CNNConfig(conv1=4, conv2=8, fc=32)
    task_kw = dict(iid=False, num_clients=8, train_n=4000, test_n=500,
                   local_batches_per_step=4, cnn_cfg=cfg_cnn)
    cfg = api.RunConfig(algorithm="csmaafl", iterations=64, eval_every=16,
                        timing=api.TimingConfig(tau_u=0.05, tau_d=0.05))
    p0 = cnn.init_params(cfg_cnn, torch.Generator().manual_seed(0))
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for dev in ("cpu", device):
            task = CNNTask(device=dev, **task_kw)
            fleet = make_fleet(8, tau=1.0, hetero_a=8.0, seed=0,
                               samples_per_client=task.num_samples())
            before = wa.weighted_agg_flat2d.launches
            res = api.run(task, cfg, fleet=fleet, eval_fn=task.eval_fn,
                          params0={k: v.to(dev) for k, v in p0.items()})
            if dev != "cpu":
                torch.cuda.synchronize()
            runs[str(dev)] = (res, wa.weighted_agg_flat2d.launches - before)
    finally:
        torch.backends.cudnn.deterministic = False
    (cpu_res, cpu_launches), (card_res, card_launches) = runs.values()
    eng = AggEngine(p0)
    diff = float((eng.flatten(card_res.params).cpu()
                  - eng.flatten(cpu_res.params)).abs().max())
    fields = {"max_abs_param_diff": diff, "tol": 1e-5,
              "card_launches": card_launches, "cpu_launches": cpu_launches,
              "times_equal": card_res.history.times == cpu_res.history.times,
              "accuracy_cpu": cpu_res.history.series("accuracy").tolist(),
              "accuracy_card": card_res.history.series("accuracy").tolist()}
    check(diff <= 1e-5, f"reduced run CPU vs card: {fields}")
    check(fields["times_equal"], "reduced run: history times differ")
    check(cpu_launches == 0 and card_launches == 64,
          f"reduced run launches: {fields}")
    return fields


def main_path(device, events):
    import math

    import torch

    from repro_torch import api
    from repro_torch.core.scheduler import make_fleet
    from repro_torch.core.tasks import CNNTask
    from repro_torch.kernels.weighted_agg import weighted_agg as wa

    t0 = time.perf_counter()
    task = CNNTask(variant="digits", iid=False, train_n=60000, test_n=10000)
    fleet = make_fleet(100, tau=1.0, hetero_a=8.0, seed=0,
                       samples_per_client=task.num_samples())
    p0 = task.init_params(0)
    plane = task.client_plane(fleet)
    check(plane.engine.n == N_CNN, f"flat row is {plane.engine.n}")
    timing = api.TimingConfig(tau_u=0.05, tau_d=0.05)
    setup_s = time.perf_counter() - t0
    runs = [("fedavg", 2, 1), ("csmaafl", events, events // 5),
            ("afl_baseline", events, 50)]
    out = {}
    wa.weighted_agg_flat2d.launches = 0      # read after the whole path
    for algorithm, iterations, eval_every in runs:
        cfg = api.RunConfig(algorithm=algorithm, iterations=iterations,
                            eval_every=eval_every, timing=timing)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = wa.weighted_agg_flat2d.launches
        t0 = time.perf_counter()
        res = api.run(task, cfg, fleet=fleet, client_plane=plane,
                      params0=p0, eval_fn=task.eval_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = wa.weighted_agg_flat2d.launches - before
        params, hist = res if algorithm == "fedavg" else \
            (res.params, res.history)
        acc = hist.series("accuracy").tolist()
        rec = {"algorithm": algorithm, "iterations": iterations,
               "times": hist.times, "accuracy": acc, "wall_s": wall,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": launches}
        if algorithm == "fedavg":
            expected = iterations                  # one C=M launch a round
        else:
            expected = res.stats["faults"]["accepted"]   # one C=1 an event
            rec["accepted"] = expected
            rec["events_per_s"] = iterations / wall
        emit("main", **rec)
        check(launches == expected,
              f"{algorithm}: {launches} launches, expected {expected}")
        check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in acc),
              f"{algorithm}: accuracy {acc}")
        check(all(bool(torch.isfinite(v).all()) for v in params.values()),
              f"{algorithm}: non-finite parameters")
        out[algorithm] = rec
    acc = out["csmaafl"]["accuracy"]
    check(acc[-1] > acc[0], f"csmaafl accuracy did not rise: {acc}")
    return (out, setup_s, wa.weighted_agg_flat2d.launches,
            (task, fleet, plane, p0))


# ---------------------------------------------------------------------------
# phases 6 and 8: LM serving
# ---------------------------------------------------------------------------
def _off_zero(tree, gen):
    """Norm scales, QKV biases and Mamba2's conv bias moved off zero (in
    place), so the (1+scale) norms and the bias adds are exercised."""
    import torch

    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _off_zero(leaf, gen)
        elif isinstance(leaf, list):
            for item in leaf:
                _off_zero(item, gen)
        elif name in ("scale", "bq", "bk", "bv", "norm_scale", "conv_b"):
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=gen,
                                        dtype=leaf.dtype))


def reduced_serve_cpu_vs_card(device, arch="qwen2-0.5b", steps=8):
    """Reduced ``arch`` (qwen2-0.5b or mamba2-780m) with the same port
    parameters: prefill (flash path; for Mamba2 every SSD) of 2 × 40
    tokens and ``steps`` greedy decode steps on the CPU (plain versions)
    and on the card (kernels).  Logits and float caches ≤1e-5·(1+max),
    integer caches (slot positions) and tokens equal; on the card one
    launch of the path's kernel (flash forward, or SSD scan) per layer,
    none of any other kernel, and none on the CPU."""
    import numpy as np
    import torch

    from repro_torch._tree import leaves, tree_map
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tmod

    cfg = get_config(arch).reduced()
    p_cpu = tmod.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    _off_zero(p_cpu, torch.Generator().manual_seed(1))
    B, S = 2, 40
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)))
    runs = []
    for dev in (torch.device("cpu"), device):
        params = tree_map(lambda t: t.to(dev), p_cpu)
        cache = tmod.init_cache(cfg, B, S + steps, dtype=torch.float32,
                                device=dev)
        before = _launch_counts()
        logits, cache = tmod.prefill(params, cfg, {"tokens": tokens.to(dev)},
                                     cache, attn_impl="pallas")
        launches = _since(before)
        outs, toks = [logits.cpu()], []
        for step in range(steps):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            toks.append(tok.cpu())
            logits, cache = tmod.decode_step(params, cfg, tok, cache,
                                             S + step)
            outs.append(logits.cpu())
        runs.append((outs, toks, tree_map(lambda t: t.cpu(), cache),
                     launches))
    (c_out, c_tok, c_cache, c_n), (g_out, g_tok, g_cache, g_n) = runs
    logit_err = max(float((g - c).abs().max() / (1 + c.abs().max()))
                    for g, c in zip(g_out, c_out))
    cache_err = 0.0
    for gl, cl in zip(leaves(g_cache), leaves(c_cache)):
        if not gl.is_floating_point():
            check(torch.equal(gl, cl), f"reduced serve {arch}: slot "
                  f"positions differ")
            continue
        cache_err = max(cache_err, float(
            (gl - cl).abs().max() / (1 + cl.abs().max())))
    kernel = "ssd_scan" if cfg.ssm is not None else "flash_fwd"
    want = {k: (cfg.num_layers if k == kernel else 0) for k in g_n}
    fields = {"arch": arch, "steps": steps, "logit_rel_err": logit_err,
              "cache_rel_err": cache_err, "tol": 1e-5,
              "tokens_equal": all(torch.equal(a, b)
                                  for a, b in zip(g_tok, c_tok)),
              "card_launches": g_n[kernel], "cpu_launches": c_n[kernel]}
    check(logit_err <= 1e-5 and cache_err <= 1e-5,
          f"reduced serve {arch} CPU vs card: {fields}")
    check(fields["tokens_equal"], f"reduced serve tokens differ: {fields}")
    check(not any(c_n.values()) and g_n == want,
          f"reduced serve {arch} launches: {g_n}, expected {want}")
    return fields


def _serve_path(cfg, params, prompts, queue, attn_impl="auto"):
    """One serving main path: prefill of ``prompts`` (SERVE_B × SERVE_S
    tokens), SERVE_STEPS greedy decode steps, then the batched server over
    ``queue`` on 4 slots.  Every launch count is set to 0 just before and
    read after the prefill and after the whole path.  Returns (the
    prefill's logits, the times and rates, the counts after the prefill,
    the counts after the path)."""
    import torch

    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import transformer as tmod

    _zero_launch_counts()
    cache = tmod.init_cache(cfg, SERVE_B, SERVE_S + SERVE_STEPS,
                            dtype=torch.float32, device=prompts.device)
    t0 = time.perf_counter()
    logits, cache = tmod.prefill(params, cfg, {"tokens": prompts}, cache,
                                 attn_impl=attn_impl)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill, first = _launch_counts(), logits
    t0 = time.perf_counter()
    for step in range(SERVE_STEPS):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        logits, cache = tmod.decode_step(params, cfg, tok, cache,
                                         SERVE_S + step)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(logits.shape == (SERVE_B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.arch_id} decode logits are not finite or not (B, 1, V)")
    del cache
    server = BatchedServer(cfg, params, slots=4, max_len=64 + 16 + 4)
    t0 = time.perf_counter()
    done = server.run(list(queue))
    torch.cuda.synchronize()
    server_s = time.perf_counter() - t0
    check(sorted(r.rid for r in done) == [r.rid for r in queue]
          and all(r.done and len(r.generated) == r.max_new for r in done),
          f"the batched {cfg.arch_id} server did not finish every request")
    rates = {"prefill_s": prefill_s,
             "prefill_tokens_per_s": SERVE_B * SERVE_S / prefill_s,
             "decode_s": decode_s,
             "decode_tokens_per_s": SERVE_B * SERVE_STEPS / decode_s,
             "server_requests": len(done), "server_s": server_s,
             "server_tokens_per_s": sum(len(r.generated) for r in done)
             / server_s}
    return first, rates, after_prefill, _launch_counts()


def _serve_setup(arch, device):
    """``arch`` at full width with f32 parameters from the port's seeded
    init on the card, the prefill prompts and a queue of 8 requests of 64
    tokens (16 to generate each)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Request
    from repro_torch.models import transformer as tmod

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = tmod.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    n_params = tmod.num_params(params)
    check(n_params == cfg.param_count,
          f"{arch} has {n_params} parameters, not {cfg.param_count}")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S))).to(device)
    queue = [Request(i, rng.integers(0, cfg.vocab_size, 64)
                     .astype(np.int32), 16) for i in range(8)]
    torch.cuda.synchronize()
    rec = {"arch": arch, "params": n_params,
           "setup_s": time.perf_counter() - t0, "batch": SERVE_B,
           "prompt": SERVE_S, "decode_steps": SERVE_STEPS}
    torch.cuda.reset_peak_memory_stats()
    return cfg, params, prompts, queue, rec


def serve_main_path(device):
    """The serving main path at qwen2-0.5b's full width (``_serve_path``
    with the flash prefill): one flash launch per layer.  Then, outside
    the count, the same prefill through the naive path: last-position
    logits within 1e-4·(1+max) and equal argmax."""
    import torch

    from repro_torch.models import transformer as tmod

    cfg, params, prompts, queue, rec = _serve_setup("qwen2-0.5b", device)
    check(rec["params"] == 494_032_768, f"qwen2-0.5b: {rec}")
    pallas_last, rates, pre, post = _serve_path(cfg, params, prompts, queue,
                                                attn_impl="pallas")
    peak = torch.cuda.max_memory_allocated()
    naive, _ = tmod.prefill(params, cfg, {"tokens": prompts},
                            tmod.init_cache(cfg, SERVE_B, SERVE_S,
                                            dtype=torch.float32,
                                            device=device),
                            attn_impl="naive")
    err = float((pallas_last - naive).abs().max())
    tol = 1e-4 * (1.0 + float(naive.abs().max()))
    same = torch.equal(torch.argmax(pallas_last[:, -1], -1),
                       torch.argmax(naive[:, -1], -1))
    rec.update(rates)
    rec.update({"max_memory_allocated": peak,
                "prefill_launches": pre["flash_fwd"],
                "launches": post["flash_fwd"],
                "pallas_vs_naive_max_abs": err, "tol": tol,
                "argmax_equal": same})
    want = {k: 0 for k in post}
    want["flash_fwd"] = cfg.num_layers
    check(pre == want and post == want, f"flash launches: {rec}")
    check(err <= tol and same,
          f"pallas vs naive prefill: {rec}")
    return rec, (cfg, params, prompts)


def _count_plain_ssd():
    """Route every module's ``ssd_chunked`` through a counter; returns
    (calls, undo)."""
    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.kernels.ssd_scan import ssd_scan as wrapper
    from repro_torch.models import mamba2

    plain = mamba2.ssd_chunked
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    mods = (mamba2, ref, wrapper, ops)
    for mod in mods:
        mod.ssd_chunked = counted

    def undo():
        for mod in mods:
            mod.ssd_chunked = plain
    return calls, undo


def serve_mamba2_main_path(device):
    """The Mamba2 serving main path at mamba2-780m's full width
    (``_serve_path``): one SSD launch per layer and prefill, y and the
    state from one pass, so 48 for the 4 × 512 prefill and 48 for each of
    the server's 8 one-row prefills; every module's plain
    ``ssd_chunked`` is counted over the same span and must not be called.
    Then, outside the count, a SERVE_S-token prefill against a
    (SERVE_S − 1)-token prefill (padded to the chunk) and one decode step
    of the last token: the last logits ≤1e-4·(1+max) and equal argmax,
    which holds the kernel's final state against the decode recurrence."""
    import torch

    from repro_torch.models import transformer as tmod

    cfg, params, prompts, queue, rec = _serve_setup("mamba2-780m", device)
    check(rec["params"] == 780_148_992, f"mamba2-780m: {rec}")
    plain_calls, undo = _count_plain_ssd()
    try:
        _, rates, pre, post = _serve_path(cfg, params, prompts, queue)
        plain = plain_calls[0]
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()

    def cache(S):
        return tmod.init_cache(cfg, SERVE_B, S, dtype=torch.float32,
                               device=device)

    full, _ = tmod.prefill(params, cfg, {"tokens": prompts}, cache(SERVE_S))
    _, part = tmod.prefill(params, cfg, {"tokens": prompts[:, :-1]},
                           cache(SERVE_S))
    stepped, _ = tmod.decode_step(params, cfg, prompts[:, -1:], part,
                                  SERVE_S - 1)
    torch.cuda.synchronize()
    err = float((full - stepped).abs().max())
    tol = 1e-4 * (1.0 + float(full.abs().max()))
    same = torch.equal(full[:, -1].argmax(-1), stepped[:, -1].argmax(-1))
    rec.update(rates)
    rec.update({"max_memory_allocated": peak,
                "prefill_launches": pre["ssd_scan"], "launches": post,
                "plain_ssd_calls": plain,
                "prefill_vs_decode_max_abs": err, "tol": tol,
                "argmax_equal": same})
    want = {k: 0 for k in post}
    want["ssd_scan"] = cfg.num_layers * (1 + len(queue))
    check(pre["ssd_scan"] == cfg.num_layers and post == want,
          f"mamba2 launches: {rec}, expected {want}")
    check(plain == 0, f"the plain SSD ran on the serving path: {rec}")
    check(err <= tol and same, f"mamba2 prefill vs decode: {rec}")
    return rec, (cfg, params, prompts)


# ---------------------------------------------------------------------------
# phases 6b and 8b: federated LM training
# ---------------------------------------------------------------------------
def _launch_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.weighted_agg import weighted_agg as wa
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "flash_bwd_dq": fa.flash_attention_bwd.launches_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd.launches_dkv,
            "weighted_agg": wa.weighted_agg_flat2d.launches,
            "ssd_scan": ssd.ssd_scan_fwd.launches}


def _zero_launch_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.weighted_agg import weighted_agg as wa
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches_dq = 0
    fa.flash_attention_bwd.launches_dkv = 0
    wa.weighted_agg_flat2d.launches = 0
    ssd.ssd_scan_fwd.launches = 0


def _since(before):
    now = _launch_counts()
    return {k: now[k] - before[k] for k in now}


def _tree_rel_err(a, b):
    """max over leaves of max|a−b| / (1+max|b|), b the reference."""
    from repro_torch._tree import leaves
    return max(float((x.cpu().float() - y.cpu().float()).abs().max()
                     / (1.0 + float(y.float().abs().max())))
               for x, y in zip(leaves(a), leaves(b)))


def _step_grads(params, cfg, fed, batches, coefs, impl, device):
    """The gradients a fused step takes from ``params``, outside its
    update (where lr·g would hide a gradient error under the parameters'
    rounding): K = 1, the folded-rows gradient of the whole step
    (``fed.grad_accum`` micro-batches included); K > 1, each client's
    first local gradient, as a list."""
    import torch

    from repro_torch.core import distributed as dist

    b = {n: torch.as_tensor(x, device=device, dtype=torch.int64)
         for n, x in batches.items()}
    if fed.local_steps == 1:
        cc = torch.as_tensor(coefs, dtype=torch.float32, device=device)[1:]
        return dist.fused_value_and_grad(params, b, cc, cfg=cfg, fed=fed,
                                         attn_impl=impl)[1]
    return [dist._value_and_grad(params, cfg,
                                 {n: x[c, 0] for n, x in b.items()}, impl)[1]
            for c in range(b["tokens"].shape[0])]


def reduced_train_cpu_vs_card(device):
    """Reduced qwen2-0.5b (2 layers, remat off) through the fused step with
    ``attn_impl="pallas"``, on the CPU (plain versions) and on the card
    (kernels), from the same parameters and batches: the K=1 CSMAAFL step,
    the K=1 step in 2 micro-batches and the K=2 step (per-client local
    SGD, blended per leaf by weighted_agg).  Parameters ≤1e-5·(1+max) per
    leaf, and the step's gradients (``_step_grads``) ≤1e-5·(1+max|g|) per
    leaf; on the card one flash forward, dQ and dK/dV launch per layer
    and gradient, one weighted_agg launch per leaf on the K=2 path, none
    on the CPU."""
    import numpy as np
    import torch

    from repro_torch._tree import leaves, tree_map
    from repro_torch.configs.base import FederatedConfig, get_config
    from repro_torch.core import distributed as dist
    from repro_torch.models import transformer as tmod

    cfg = get_config("qwen2-0.5b").reduced()
    p_cpu = tmod.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    _off_zero(p_cpu, torch.Generator().manual_seed(1))
    n_leaves = len(leaves(p_cpu))
    rng = np.random.default_rng(1)
    cases = {   # name: (C, K, rows, grad_accum, coefs)
        "k1": (3, 1, 2, 1, [0.2, 0.5, 0.2, 0.1]),
        "k1_grad_accum2": (2, 1, 4, 2, [0.1, 0.6, 0.3]),
        "k2": (2, 2, 2, 1, [0.4, 0.3, 0.3]),
    }
    out = {}
    for name, (C, K, rows, M, coefs) in cases.items():
        batches = {n: rng.integers(0, cfg.vocab_size, (C, K, rows, 40))
                   .astype(np.int32) for n in ("tokens", "labels")}
        fed = FederatedConfig(local_steps=K, grad_accum=M)
        res = []
        for dev in (torch.device("cpu"), device):
            step = dist.make_csmaafl_step(cfg, fed, attn_impl="pallas",
                                          device=dev)
            p = tree_map(lambda t: t.to(dev), p_cpu)
            before = _launch_counts()
            new, m = step(p, batches, coefs, 1e-2)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            n = _since(before)
            res.append((new, float(m["loss"]), n,
                        _step_grads(p, cfg, fed, batches, coefs, "pallas",
                                    dev)))
        (c_new, c_loss, c_n, c_g), (g_new, g_loss, g_n, g_g) = res
        grads = C * K if K > 1 else M
        want = {"flash_fwd": cfg.num_layers * grads,
                "flash_bwd_dq": cfg.num_layers * grads,
                "flash_bwd_dkv": cfg.num_layers * grads,
                "weighted_agg": n_leaves if K > 1 else 0, "ssd_scan": 0}
        rec = {"param_rel_err": _tree_rel_err(g_new, c_new),
               "grad_rel_err": _tree_rel_err(g_g, c_g), "tol": 1e-5,
               "loss_cpu": c_loss, "loss_card": g_loss,
               "card_launches": g_n, "cpu_launches": c_n}
        check(rec["param_rel_err"] <= 1e-5 and rec["grad_rel_err"] <= 1e-5
              and abs(g_loss - c_loss) <= 1e-5 * (1 + abs(c_loss)),
              f"reduced train {name} CPU vs card: {rec}")
        check(g_n == want and not any(c_n.values()),
              f"reduced train {name} launches: {rec}, expected {want}")
        out[name] = rec
    return out


def train_main_path(device):
    """The training main path at qwen2-0.5b's full width, f32 parameters
    from the port's seeded init, ``attn_impl="pallas"``: ``run_spmd`` with
    C = TRAIN_C clients of TRAIN_ROWS × TRAIN_S tokens a step, 8 CSMAAFL
    steps, 2 FedAvg steps (``make_sfl_step``) and 1 step with K = 2
    local steps (per-client SGD, blended by weighted_agg at C = 4).  The
    launch counts are set to 0 just before and read just after; peak
    device memory is read per run (the initial parameters stay allocated
    throughout).  Then, outside the count, one step from the initial
    parameters on each client stream's first batch through the flash
    kernels and through the naive attention: loss and parameters
    ≤1e-5·(1+max)."""
    import math

    import numpy as np
    import torch

    from repro_torch._tree import leaves
    from repro_torch.configs.base import FederatedConfig, get_config
    from repro_torch.core import distributed as dist
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.train import run_spmd
    from repro_torch.models import transformer as tmod

    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    p0 = tmod.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kw = dict(clients=TRAIN_C, batch=TRAIN_ROWS, seq=TRAIN_S,
              attn_impl="pallas", device=device)
    _zero_launch_counts()                         # read after the path
    runs, params = {}, p0
    peak = 0
    for name, steps, algorithm, K in (("csmaafl", 8, "csmaafl", 1),
                                      ("fedavg", 2, "fedavg", 1),
                                      ("csmaafl_k2", 1, "csmaafl", 2)):
        before = _launch_counts()
        torch.cuda.reset_peak_memory_stats()
        run = run_spmd(cfg, steps=steps, algorithm=algorithm,
                       params=params, local_steps=K, **kw)
        torch.cuda.synchronize()
        run_peak = torch.cuda.max_memory_allocated()
        peak = max(peak, run_peak)
        params = run.params
        n = _since(before)
        later = sorted(run.step_s[1:]) or run.step_s
        med = later[len(later) // 2]
        runs[name] = {
            "steps": steps, "local_steps": K, "losses": run.losses,
            "coef0": [float(c[0]) for c in run.coefs],
            "step_s": run.step_s, "median_step_s_after_first": med,
            "train_tokens_per_s": TRAIN_C * K * TRAIN_ROWS * TRAIN_S / med,
            "data_s": run.data_s, "launches": n,
            "max_memory_allocated": run_peak,
            "launches_per_step": {k: v / steps for k, v in n.items()}}
        check(all(math.isfinite(x) for x in run.losses),
              f"train {name}: losses {run.losses}")
    launches = _launch_counts()
    check(all(bool(torch.isfinite(t).all()) for t in leaves(params)),
          "train: non-finite parameters")
    L, n_leaves = cfg.num_layers, len(leaves(p0))
    grads = 8 + 2 + TRAIN_C * 2       # gradient computations on the path
    fwd = 2 if cfg.remat else 1       # remat recomputes each forward
    want = {"flash_fwd": fwd * L * grads, "flash_bwd_dq": L * grads,
            "flash_bwd_dkv": L * grads, "weighted_agg": n_leaves,
            "ssd_scan": 0}
    check(launches == want, f"train launches {launches}, expected {want}")
    del params, run

    # one step through the flash kernels and through the naive attention,
    # on each client stream's first batch, FedAvg coefficients: the
    # updated parameters, and the step's gradient itself (lr·g alone
    # would hide a gradient error under the parameters' rounding)
    draws = [TokenStream(cfg.vocab_size, cid=c, seed=0)
             .sample_batch(TRAIN_ROWS, TRAIN_S) for c in range(TRAIN_C)]
    batch = {n: np.stack([d[n] for d in draws])[:, None]
             for n in ("tokens", "labels")}
    coefs = np.full(TRAIN_C + 1, 1.0 / TRAIN_C, np.float32)
    coefs[0] = 0.0
    fed = FederatedConfig(num_clients=TRAIN_C)
    out, grad = {}, {}
    for impl in ("pallas", "naive"):
        step = dist.make_csmaafl_step(cfg, fed, attn_impl=impl, device=device)
        out[impl] = step(p0, batch, coefs, fed.lr)
        grad[impl] = _step_grads(p0, cfg, fed, batch, coefs, impl, device)
    torch.cuda.synchronize()
    (pn, pm), (nn_, nm) = out["pallas"], out["naive"]
    loss_p, loss_n = float(pm["loss"]), float(nm["loss"])
    param_err = _tree_rel_err(pn, nn_)
    grad_err = _tree_rel_err(grad["pallas"], grad["naive"])
    grad_diff = max(float((a - b).abs().max()) for a, b in
                    zip(leaves(grad["pallas"]), leaves(grad["naive"])))
    rec = {"arch": cfg.arch_id, "params": tmod.num_params(p0),
           "clients": TRAIN_C, "rows": TRAIN_ROWS, "seq": TRAIN_S,
           "tokens_per_step": TRAIN_C * TRAIN_ROWS * TRAIN_S,
           "setup_s": setup_s, "runs": runs, "launches": launches,
           "max_memory_allocated": peak,
           "pallas_vs_naive": {"loss_pallas": loss_p, "loss_naive": loss_n,
                               "param_rel_err": param_err,
                               "grad_rel_err": grad_err, "tol": 1e-5,
                               "max_grad_diff": grad_diff}}
    check(abs(loss_p - loss_n) <= 1e-5 * (1 + abs(loss_n))
          and param_err <= 1e-5 and grad_err <= 1e-5,
          f"train pallas vs naive: {rec}")
    del pn, nn_, out, grad
    return rec, (cfg, p0, batch, coefs)


# ---------------------------------------------------------------------------
# phase 10: where the time of a run goes
# ---------------------------------------------------------------------------
def device_spans(prof):
    """Device kernel spans of a trace, the device's busy time (union of
    the spans, µs) and {name: (device µs, count)}."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(spans, "the profiler saw no device activity")
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        t, k = by_name.get(name, (0.0, 0))
        by_name[name] = (t + stop - start, k + 1)
    return spans, busy, by_name


def top_kernels(by_name, n=8):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:80], "device_us": v[0], "count": v[1]}
            for k, v in top]


def profile_run(task, fleet, plane, p0, events):
    """Device busy share and device time by kernel over a short CSMAAFL
    run at full width (no eval), from a torch.profiler trace: the fleet's
    initial training plus ``events`` events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api

    cfg = api.RunConfig(algorithm="csmaafl", iterations=events,
                        timing=api.TimingConfig(tau_u=0.05, tau_d=0.05))
    torch.cuda.synchronize()
    # device activity only: host op events would multiply the trace and
    # its processing time, and the busy share needs kernels alone
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = api.run(task, cfg, fleet=fleet, client_plane=plane,
                      params0=p0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, busy, by_name = device_spans(prof)
    steps = task.local_batches * (sum(c.local_steps for c in fleet)
                                  + sum(e.local_steps for e in res.events))
    agg = [v for k, v in by_name.items() if "weighted_agg" in k]
    return {"events": events, "sgd_steps": steps, "wall_s": wall_us / 1e6,
            "ms_per_sgd_step": wall_us / 1e3 / steps,
            "device_busy_share": busy / wall_us,
            "device_kernels": len(spans),
            "kernels_per_sgd_step": len(spans) / steps,
            "weighted_agg_device_us": sum(v[0] for v in agg),
            "top_kernels": top_kernels(by_name)}


def profile_serve(state, kernel="flash_fwd", label="flash",
                  decode_steps=8):
    """Device busy share and device time by kernel over one full-width
    prefill of the serving batch (through the kernel whose name holds
    ``kernel``: the flash forward, or the SSD scan), and over
    ``decode_steps`` decode steps after it, from two torch.profiler
    traces; the kernel's device time, launches and share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tmod

    cfg, params, prompts = state
    B, S = prompts.shape
    cache = tmod.init_cache(cfg, B, S + decode_steps, dtype=torch.float32,
                            device=prompts.device)
    out = {}
    torch.cuda.synchronize()
    for part in ("prefill", "decode"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if part == "prefill":
                logits, cache = tmod.prefill(params, cfg,
                                             {"tokens": prompts}, cache,
                                             attn_impl="pallas")
            else:
                for step in range(decode_steps):
                    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                    logits, cache = tmod.decode_step(params, cfg, tok,
                                                     cache, S + step)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans, busy, by_name = device_spans(prof)
        hit = [v for k, v in by_name.items() if kernel in k]
        device_us = sum(v[0] for v in by_name.values())
        steps = decode_steps if part == "decode" else 1
        out[part] = {"wall_ms": wall_us / 1e3,
                     "device_busy_share": busy / wall_us,
                     "device_kernels": len(spans),
                     "kernels_per_step": len(spans) / steps,
                     f"{label}_device_us": sum(v[0] for v in hit),
                     f"{label}_launches": sum(v[1] for v in hit),
                     f"{label}_share_of_device_time":
                         sum(v[0] for v in hit) / device_us,
                     "top_kernels": top_kernels(by_name)}
    out["decode_steps"] = decode_steps
    return out


def profile_train(state):
    """Device busy share and device time by kernel over one full-width
    fused step (K=1, flash kernels, remat), from a torch.profiler trace;
    the flash forward's and backward's shares of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import distributed as dist

    cfg, p0, batch, coefs = state
    fed = FederatedConfig(num_clients=TRAIN_C)
    step = dist.make_csmaafl_step(cfg, fed, attn_impl="pallas",
                                  device=p0["embed"].device)
    step(p0, batch, coefs, fed.lr)                 # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new, _ = step(p0, batch, coefs, fed.lr)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    del new
    spans, busy, by_name = device_spans(prof)
    device_us = sum(v[0] for v in by_name.values())

    def part(tag):
        hit = [v for k, v in by_name.items() if tag in k]
        t = sum(v[0] for v in hit)
        return {"device_us": t, "launches": sum(v[1] for v in hit),
                "share_of_device_time": t / device_us}

    return {"wall_ms": wall_us / 1e3, "device_busy_share": busy / wall_us,
            "device_kernels": len(spans), "device_us": device_us,
            "flash_fwd": part("flash_fwd"),
            "flash_bwd_dq": part("flash_bwd_dq"),
            "flash_bwd_dkv": part("flash_bwd_dkv"),
            "top_kernels": top_kernels(by_name, 10)}


# ---------------------------------------------------------------------------
# phase 9: timing
# ---------------------------------------------------------------------------
def time_graph(fn, sets, launches, replays=10):
    """Median time of one call of ``fn``, from CUDA events around
    replays of a CUDA graph of ``launches`` calls.  Calls rotate through
    ``sets`` input sets and every output stays alive, so inputs and
    outputs are spread over more memory than the 50 MB L2 holds."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):                     # warm-up outside capture
            fn(sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for i in range(launches):
            outs.append(fn(sets[i % len(sets)]))
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del outs, graph
    times.sort()
    return times[len(times) // 2]


def time_events(fn, sets, launches, replays=5):
    """Median time of one call of ``fn`` from CUDA events around
    ``launches`` eager calls (for a library call that a CUDA graph cannot
    hold, such as an autograd backward)."""
    import torch

    for i in range(3):
        fn(sets[i % len(sets)])
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(launches):
            fn(sets[i % len(sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    times.sort()
    return times[len(times) // 2]


def bound(C, n, itemsize=4):
    moved = (C + 2) * n * itemsize + (C + 1) * 4   # inputs once, output once
    flops = (2 * C + 1) * n
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", moved)


def kernel_timing(device):
    import torch

    from repro_torch.kernels.weighted_agg.ref import weighted_agg_ref
    from repro_torch.kernels.weighted_agg.weighted_agg import (
        weighted_agg_flat2d)

    gen = torch.Generator(device=device).manual_seed(1)
    results = {}
    # C=1 and C=M=100 over the CNN's flat row (the AFL path), C=4 over
    # qwen2-0.5b's largest leaf, the embedding (the K=2 train step)
    for C, n, nsets, launches in ((1, N_CNN, 8, 200), (100, N_CNN, 2, 8),
                                  (4, N_QWEN_EMBED, 1, 4)):
        width = -(-n // 64) * 64               # the plane's row stride
        sets = []
        for _ in range(nsets):
            rows = torch.randn(C, width, generator=gen,
                               device=device)[:, :n]
            g = torch.randn(n, generator=gen, device=device)
            coefs = torch.rand(C + 1, generator=gen, device=device)
            sets.append((g, rows, coefs, float(coefs[0])))
        fns = {
            "ms": lambda s: weighted_agg_flat2d(s[0], s[1], s[2]),
            "plain_ms": lambda s: weighted_agg_ref(s[0], s[1], s[2]),
        }
        if C == 1:
            # β·g + (1−β)·w as one library call (coefs here are [β, 1−β]
            # only up to rounding; the yardstick is timing, not values)
            fns["library_ms"] = lambda s: torch.lerp(s[1][0], s[0], s[3])
        else:
            fns["library_ms"] = lambda s: torch.addmv(
                s[0], s[1].t(), s[2][1:], beta=s[3])
        rec = {name: time_graph(fn, sets, launches)
               for name, fn in fns.items()}
        b, by, moved = bound(C, n)
        rec.update({"C": C, "n": n, "bound_ms": b, "bound_by": by,
                    "bytes": moved, "input_sets": nsets,
                    "working_set_bytes": nsets * (C + 1) * n * 4,
                    "launches_per_graph": launches})
        rec["achieved_GBps"] = moved / (rec["ms"] * 1e-3) / 1e9
        emit("timing", **rec)
        results[C] = rec
    return results


def flash_bound(B, H, Hkv, S, D, itemsize=4):
    """Least time for causal attention on the card: q, k, v read once,
    out and the f32 lse written once, at 3.35 TB/s; against the causal
    products' flops, 2·2·B·H·D·S(S+1)/2 (QKᵀ and PV over the keys each row
    attends to), at the f32 rate outside the tensor cores (67 TFLOP/s),
    which is the rate the kernel computes at."""
    moved = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize \
        + B * H * S * 4
    flops = 2 * B * H * D * S * (S + 1)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", moved, flops)


def flash_timing(device, nsets=4, launches=20):
    """The flash kernel at the serving main path's shape (qwen2-0.5b
    prefill: B=4, S=512, 14 heads over 2 kv heads, D=64, f32, causal, in
    the model's (B, S, H, D) layout), its plain version, and
    ``F.scaled_dot_product_attention`` on the same inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, H, Hkv, S, D = SERVE_B, 14, 2, SERVE_S, 64
    gen = torch.Generator(device=device).manual_seed(3)
    sets = [tuple(torch.randn(B, S, h, D, generator=gen, device=device)
                  .transpose(1, 2) for h in (H, Hkv, Hkv))
            for _ in range(nsets)]
    fns = {
        "ms": lambda s: flash_attention_fwd(*s, causal=True),
        "plain_ms": lambda s: attention_ref(*s, causal=True),
        "library_ms": lambda s: F.scaled_dot_product_attention(
            *s, is_causal=True, enable_gqa=True),
    }
    rec = {name: time_graph(fn, sets, launches) for name, fn in fns.items()}
    b, by, moved, flops = flash_bound(B, H, Hkv, S, D)
    rec.update({"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
                "bound_ms": b, "bound_by": by, "bytes": moved,
                "flops": flops, "input_sets": nsets,
                "launches_per_graph": launches,
                "achieved_TFLOPs": flops / (rec["ms"] * 1e-3) / 1e12,
                "library_achieved_TFLOPs":
                    flops / (rec["library_ms"] * 1e-3) / 1e12})
    emit("timing", kernel="flash_attention_fwd", **rec)
    return rec


def flash_bwd_bound(which, B, H, Hkv, S, D, itemsize=4):
    """Least time of one backward kernel on the card: its causal products
    (dQ: QKᵀ, dO·Vᵀ, dS·K; dK/dV: those two and Pᵀ·dO, dSᵀ·Q), each
    2·B·H·D·S(S+1)/2 flops, at the f32 rate outside the tensor cores
    (67 TFLOP/s), against its bytes at 3.35 TB/s: dQ reads q, k, v, dout,
    lse, δ and writes dq; dK/dV reads the same and writes dk, dv."""
    products = 3 if which == "dq" else 4
    flops = products * B * H * D * S * (S + 1)
    q_like = (3 if which == "dq" else 2) * B * H * S * D
    kv_like = (2 if which == "dq" else 4) * B * Hkv * S * D
    moved = (q_like + kv_like) * itemsize + 2 * B * H * S * 4
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", moved, flops)


def flash_bwd_timing(device, nsets=3, launches=10):
    """The dQ and dK/dV kernels at the training main path's shape
    (B = 8, S = 512, 14 heads over 2 kv heads, D = 64, f32, causal, in
    the model's (B, S, H, D) layout), each timed alone over a CUDA graph
    with its inputs (q, k, v, dout, lse, δ) precomputed; the plain
    backward (dq, dk and dv together); and the backward of
    ``F.scaled_dot_product_attention(is_causal, enable_gqa)`` on the same
    inputs, timed eagerly (an autograd backward is not graph-captured)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    B, H, Hkv, S, D = TRAIN_B, 14, 2, TRAIN_S, 64
    gen = torch.Generator(device=device).manual_seed(5)
    sets = []
    for _ in range(nsets):
        q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=device)
                       .transpose(1, 2) for h in (H, Hkv, Hkv, H))
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
        delta = (do * out).sum(-1).contiguous()
        sets.append((q, k, v, do, lse, delta, out))
    kernels = {
        "dq": lambda s: fa.flash_attention_bwd_dq(*s[:6]),
        "dkv": lambda s: fa.flash_attention_bwd_dkv(*s[:6]),
    }
    plain_ms = time_graph(lambda s: attention_bwd_ref(
        s[0], s[1], s[2], s[6], s[4], s[3]), sets, 3)
    lib_sets = []
    for q, k, v, do, *_ in sets:
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                           enable_gqa=True)
        lib_sets.append((o, leaves, do))
    library_ms = time_events(lambda s: torch.autograd.grad(
        s[0], s[1], s[2], retain_graph=True), lib_sets, launches)
    out = {}
    for which, fn in kernels.items():
        b, by, moved, flops = flash_bwd_bound(which, B, H, Hkv, S, D)
        rec = {"ms": time_graph(fn, sets, launches), "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b, "bound_by": by,
               "bytes": moved, "flops": flops, "B": B, "H": H, "Hkv": Hkv,
               "S": S, "D": D, "input_sets": nsets,
               "launches_per_graph": launches}
        rec["achieved_TFLOPs"] = flops / (rec["ms"] * 1e-3) / 1e12
        emit("timing", kernel=f"flash_attention_bwd_{which}", **rec)
        out[which] = rec
    least = 5 * B * H * D * S * (S + 1)       # the pair's least work
    emit("timing", kernel="flash_attention_bwd (dQ + dK/dV)",
         ms=out["dq"]["ms"] + out["dkv"]["ms"], library_ms=library_ms,
         plain_ms=plain_ms, least_work_flops=least,
         least_work_bound_ms=least / F32_FLOPS_PER_S * 1e3)
    return out


def ssd_bound(Bt, L, H, P, G, N, Q):
    """Least time of the SSD scan on the card: its least work at the f32
    rate outside the tensor cores (67 TFLOP/s) against its bytes at 3.35
    TB/s.  Work per chunk of Q: C·Bᵀ once per (batch, group), the causal
    half 2·Q(Q+1)/2·N; per (batch, head) the causal half of the intra
    product 2·Q(Q+1)/2·P, the inter output 2·Q·P·N and the state update
    2·Q·P·N.  Bytes: x, dt, A, B and C read once, y and the final state
    written once (f32)."""
    nc = L // Q
    flops = Bt * nc * (G * Q * (Q + 1) * N
                       + H * (Q * (Q + 1) * P + 4 * Q * P * N))
    moved = 4 * (2 * Bt * L * H * P + Bt * L * H + H + 2 * Bt * L * G * N
                 + Bt * H * P * N)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", moved, flops)


def ssd_timing(device, nsets=3, launches=12):
    """The SSD kernel at the Mamba2 serving path's prefill shape
    (mamba2-780m, 4 × 512 tokens, 48 heads of P = 64, one group of
    N = 128, chunk 128, f32, in the model's (Bt, L, H, P) layout) and its
    plain chunked op, each over a CUDA graph with input sets rotating
    beyond the 50 MB L2.  No single PyTorch call computes the SSD scan,
    so there is no library time."""
    import torch

    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd

    Q = SSD_PREFILL[6]
    gen = torch.Generator(device=device).manual_seed(7)
    sets = [_ssd_inputs(SSD_PREFILL, torch.float32, gen, device)
            for _ in range(nsets)]
    rec = {"ms": time_graph(lambda a: ssd_scan_fwd(*a, chunk=Q), sets,
                            launches),
           "plain_ms": time_graph(lambda a: ssd_chunked(*a, chunk=Q), sets,
                                  3),
           "library_ms": None}
    b, by, moved, flops = ssd_bound(*SSD_PREFILL)
    Bt, L, H, P, G, N, _ = SSD_PREFILL
    rec.update({"Bt": Bt, "L": L, "H": H, "P": P, "G": G, "N": N, "Q": Q,
                "bound_ms": b, "bound_by": by, "bytes": moved,
                "flops": flops, "input_sets": nsets,
                "launches_per_graph": launches,
                "achieved_TFLOPs": flops / (rec["ms"] * 1e-3) / 1e12})
    emit("timing", kernel="ssd_scan_fwd", **rec)
    return rec


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: {"seconds": v["seconds"], "cached": v["cached"],
                        "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                  if "entry function" in ln
                                  or "registers" in ln or "spill" in ln]}
                    for k, v in built.items()})

    cases, worst = kernel_vs_plain(device)
    emit("kernel", cases=len(cases), all_ok=all(c["ok"] for c in cases),
         max_abs_err={f"C={c}/{d}": e for (c, d), e in worst.items()},
         vector_cases=sum(c["vector"] for c in cases))
    flash_cases, flash_worst = flash_vs_plain(device)
    emit("flash", cases=flash_cases, max_abs_err=flash_worst)
    bwd_cases, bwd_worst = flash_bwd_vs_plain(device)
    emit("flash_bwd", cases=bwd_cases, max_abs_err=bwd_worst)
    ssd_cases, ssd_worst = ssd_vs_plain(device)
    emit("ssd", cases=ssd_cases, max_abs_err=ssd_worst)

    emit("reduced", **reduced_cpu_vs_card(device))
    emit("reduced_serve", **reduced_serve_cpu_vs_card(device))
    emit("reduced_train", **reduced_train_cpu_vs_card(device))
    emit("reduced_serve_mamba2",
         **reduced_serve_cpu_vs_card(device, arch="mamba2-780m"))

    events = 200
    main_runs, setup_s, total_launches, state = main_path(device, events)
    emit("main_total", setup_s=setup_s, launches=total_launches)
    serve, serve_state = serve_main_path(device)
    emit("serve", **serve)
    emit("profile_serve", **profile_serve(serve_state))
    del serve_state              # each path's peak memory is its own
    mamba, mamba_state = serve_mamba2_main_path(device)
    emit("serve_mamba2", **mamba)
    emit("profile_serve_mamba2",
         **profile_serve(mamba_state, kernel="ssd_scan", label="ssd"))
    del mamba_state
    train, train_state = train_main_path(device)
    emit("train", **train)

    timing = kernel_timing(device)
    flash_t = flash_timing(device)
    bwd_t = flash_bwd_timing(device)
    ssd_t = ssd_timing(device)

    emit("profile", **profile_run(*state, events=20))
    emit("profile_train", **profile_train(train_state))

    def entry(C, name, launches):
        t = timing[C]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": KERNEL_REPLACES, "launches": launches,
                "max_abs_err": worst[(C, "float32")], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    kernels = [
        entry(1, "weighted_agg (C=1, eq. 3 blend per event)",
              main_runs["csmaafl"]["launches"]
              + main_runs["afl_baseline"]["launches"]),
        entry(100, "weighted_agg (C=M=100, eq. 2 FedAvg round)",
              main_runs["fedavg"]["launches"]),
        entry(4, "weighted_agg (C=4, per-leaf blend of the K=2 train step; "
                 "timed on the embedding leaf)",
              train["launches"]["weighted_agg"]),
        {"name": "flash_attention_fwd (qwen2-0.5b prefill and train, f32, "
                 "causal; timed at the prefill shape)",
         "route": "cuda", "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
         "launches": serve["launches"] + train["launches"]["flash_fwd"],
         "max_abs_err": flash_worst["float32"], "ms": flash_t["ms"],
         "plain_ms": flash_t["plain_ms"], "bound_ms": flash_t["bound_ms"],
         "bound_by": flash_t["bound_by"],
         "library_ms": flash_t["library_ms"]},
    ]
    for which, label, replaces in (
            ("dq", "dQ", FLASH_DQ_REPLACES),
            ("dkv", "dK/dV", FLASH_DKV_REPLACES)):
        t = bwd_t[which]
        err = max(v for k, v in bwd_worst.items()
                  if k.endswith("/float32") and k.startswith(
                      ("dq",) if which == "dq" else ("dk", "dv")))
        kernels.append({
            "name": f"flash_attention_bwd {label} (qwen2-0.5b train, f32, "
                    f"causal)",
            "route": "cuda", "source": FLASH_BWD_SOURCE,
            "replaces": replaces,
            "launches": train["launches"][f"flash_bwd_{which}"],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    kernels.append({
        "name": "ssd_scan_fwd (mamba2-780m prefill, f32; timed at the "
                "4 × 512 prefill shape)",
        "route": "cuda", "source": SSD_SOURCE, "replaces": SSD_REPLACES,
        "launches": mamba["launches"]["ssd_scan"],
        "max_abs_err": max(ssd_worst["y/float32"],
                           ssd_worst["state/float32"]),
        "ms": ssd_t["ms"], "plain_ms": ssd_t["plain_ms"],
        "bound_ms": ssd_t["bound_ms"], "bound_by": ssd_t["bound_by"],
        "library_ms": ssd_t["library_ms"]})
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of a main path was never launched")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
