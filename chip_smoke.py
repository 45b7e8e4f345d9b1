#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — card name and count, ``nvidia-smi`` name and power limit;
2. build   — nvcc builds every kernel from the sources in this checkout;
3. kernel  — each kernel against its plain PyTorch version on the card,
             at the main path's shapes and at a ragged one;
4. reduced — a narrow-CNN CSMAAFL run on the CPU (plain version) and on
             the card (kernel): final parameters ≤1e-5, times equal;
5. main    — the main path at the paper CNN's full width, M = 100:
             FedAvg, CSMAAFL and the §III-B baseline through ``api.run``,
             with the kernel's launch count read around it;
6. timing  — kernel, plain version and the one PyTorch call computing
             the same function, timed with CUDA events;
7. profile — device busy share and device time by kernel over a short
             full-width CSMAAFL run (torch.profiler).

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failed check raises: the script exits non-zero and prints no
result, as it does when no CUDA card is present or the port is missing.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_CNN = 1_663_370              # flat parameters of the paper's MNIST CNN
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/weighted_agg/csrc/weighted_agg.cu"
KERNEL_REPLACES = "src/repro/kernels/weighted_agg/weighted_agg.py:106"


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
# phase 3: the kernel against its plain version
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


# ---------------------------------------------------------------------------
# phases 4 and 5: runs through api.run
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
# phase 7: where the time of a run goes
# ---------------------------------------------------------------------------
def profile_run(task, fleet, plane, p0, events):
    """Device busy share and device time by kernel over a short CSMAAFL
    run at full width (no eval), from a torch.profiler trace: the fleet's
    initial training plus ``events`` events."""
    import torch
    from torch.autograd import DeviceType
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
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(spans, "the profiler saw no device activity")
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        t, k = by_name.get(name, (0.0, 0))
        by_name[name] = (t + stop - start, k + 1)
    steps = task.local_batches * (sum(c.local_steps for c in fleet)
                                  + sum(e.local_steps for e in res.events))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    agg = [v for k, v in by_name.items() if "weighted_agg" in k]
    return {"events": events, "sgd_steps": steps, "wall_s": wall_us / 1e6,
            "ms_per_sgd_step": wall_us / 1e3 / steps,
            "device_busy_share": busy / wall_us,
            "device_kernels": len(spans),
            "kernels_per_sgd_step": len(spans) / steps,
            "weighted_agg_device_us": sum(v[0] for v in agg),
            "top_kernels": [{"name": k[:80], "device_us": v[0], "count": v[1]}
                            for k, v in top]}


# ---------------------------------------------------------------------------
# phase 6: timing
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

    n = N_CNN
    width = -(-n // 64) * 64                   # the plane's row stride
    gen = torch.Generator(device=device).manual_seed(1)
    results = {}
    for C, nsets, launches in ((1, 8, 200), (100, 2, 8)):
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
                                  if "registers" in ln or "spill" in ln]}
                    for k, v in built.items()})

    cases, worst = kernel_vs_plain(device)
    emit("kernel", cases=len(cases), all_ok=all(c["ok"] for c in cases),
         max_abs_err={f"C={c}/{d}": e for (c, d), e in worst.items()},
         vector_cases=sum(c["vector"] for c in cases))

    emit("reduced", **reduced_cpu_vs_card(device))

    events = 200
    main_runs, setup_s, total_launches, state = main_path(device, events)
    emit("main_total", setup_s=setup_s, launches=total_launches)

    timing = kernel_timing(device)

    emit("profile", **profile_run(*state, events=20))

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
    ]
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of the main path was never launched")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
