"""Federated LM trainer, the fused-step data plane: twin of the
``--data-plane spmd`` path of ``repro/launch/train.py``.

The control plane (scheduler + staleness coefficients) drives the fused
step (``core/distributed.py``): each step folds a *trunk* of C
scheduler-approved uploads into one update.  The scheduler yields the
next C uploads, ``fold_sequential_blends`` turns their per-iteration β_j
into the (c0, coefs) vector (FedAvg: the normalized α of the trunk), and
the step applies local SGD and the blend.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen2-0.5b --reduced --steps 20 --algorithm csmaafl

The trainer runs on the card; ``main(argv, device="cpu")`` and
``run_spmd(..., device="cpu")`` run it on the CPU.  Flags of paths the
port does not have yet raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import FederatedConfig, ModelConfig, get_config
from repro_torch.core import aggregation as agg
from repro_torch.core import distributed as dist
from repro_torch.core.scheduler import AFLScheduler, make_fleet
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import transformer as tmod

# flag -> what it needs; every one raises NotImplementedError when given
UNPORTED = {
    "data_plane": "the fleet-plane LM trainer (ROADMAP Queue 1 #13f)",
    "window_cap": "the fleet-plane LM trainer (ROADMAP Queue 1 #13f)",
    "sweep": "the sweep plane (ROADMAP Queue 1 #9)",
    "sweep_out": "the sweep plane (ROADMAP Queue 1 #9)",
    "check_parity": "the sweep plane (ROADMAP Queue 1 #9)",
    "loop": "the compiled loop (ROADMAP Queue 1 #6)",
    "resume": "checkpoints and recovery (ROADMAP Queue 1 #7)",
    "max_restarts": "checkpoints and recovery (ROADMAP Queue 1 #7)",
    "autosave": "checkpoints and recovery (ROADMAP Queue 1 #7)",
    "ckpt_dir": "checkpoints and recovery (ROADMAP Queue 1 #7)",
    "keep_last": "checkpoints and recovery (ROADMAP Queue 1 #7)",
    "guards": "update guards (ROADMAP Queue 1 #7)",
    "faults": "fault injection (ROADMAP Queue 1 #7)",
    "save": "checkpoints (ROADMAP Queue 1 #7)",
    "config": "RunConfig files (ROADMAP Queue 1 #8)",
    "mesh": "the multi-device planes (ROADMAP Queue 1 #14)",
}


@dataclasses.dataclass
class SpmdRun:
    """What ``run_spmd`` did: the final parameters and, per step, the
    trunk's clients, the coefficient vector, the loss and the wall time
    (host clock, ending in a device sync); ``data_s`` is the host time
    spent drawing every batch, before the first step."""
    params: Any
    cids: List[List[int]]
    coefs: List[np.ndarray]
    losses: List[float]
    step_s: List[float]
    data_s: float


def _trunk_coefficients(trunk, algorithm: str, alpha: np.ndarray,
                        tracker: agg.StalenessTracker,
                        gamma: float) -> np.ndarray:
    """[c0, c_1..c_C] in float32 for one trunk of uploads, as the
    reference's loop builds it."""
    if algorithm == "fedavg":
        c0, coefs = 0.0, [float(alpha[e.cid]) for e in trunk]
        s = sum(coefs)
        coefs = [c / s for c in coefs]
    else:
        betas = []
        for e in trunk:
            mu = tracker.update(e.staleness)
            betas.append(1.0 - agg.staleness_coefficient(e.j, e.i, mu,
                                                          gamma))
        c0, coefs = agg.fold_sequential_blends(betas)
    return np.asarray([c0] + list(coefs), np.float32)


def run_spmd(cfg: ModelConfig, *, steps: int, algorithm: str = "csmaafl",
             clients: int = 4, batch: int = 2, seq: int = 64,
             lr: float = 5e-3, gamma: float = 0.4, attn_impl: str = "auto",
             device: DeviceLike = None, params: Optional[Dict] = None,
             local_steps: int = 1) -> SpmdRun:
    """The reference's trainer loop: ``make_fleet(C, tau=1, hetero_a=4,
    1000 samples each, seed 0)``, ``AFLScheduler(tau_u=tau_d=0.05)``, one
    trunk of C upload events a step, coefficients from
    ``StalenessTracker`` + ``staleness_coefficient`` +
    ``fold_sequential_blends`` (FedAvg: ``sfl_alpha``), then the fused step.

    ``params`` defaults to the port's seeded init (seed 0) on the device.
    Every batch is drawn before the first step, in the reference's order
    (one ``TokenStream(seed 0)`` per client, ``local_steps`` draws per
    upload; the reference's loop has ``local_steps`` = 1), so the steps'
    wall time holds no host sampling."""
    dev = resolve_device(device)
    if algorithm not in ("csmaafl", "fedavg"):
        raise ValueError(f"the trainer drives csmaafl or fedavg, not "
                         f"{algorithm!r}")
    fed = FederatedConfig(num_clients=clients, algorithm=algorithm,
                          gamma=gamma, lr=lr, local_steps=local_steps)
    if params is None:
        params = tmod.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    # control plane and data, all on the host
    fleet = make_fleet(clients, tau=1.0, hetero_a=4.0,
                       samples_per_client=[1000] * clients, seed=0)
    events = AFLScheduler(fleet, tau_u=0.05, tau_d=0.05).events(
        steps * clients)
    tracker = agg.StalenessTracker(momentum=fed.mu_momentum)
    alpha = agg.sfl_alpha([c.num_samples for c in fleet])
    streams = [TokenStream(cfg.vocab_size, cid=c, seed=0)
               for c in range(clients)]
    cids, coefs, batches = [], [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        trunk = [next(events) for _ in range(clients)]
        cids.append([e.cid for e in trunk])
        coefs.append(_trunk_coefficients(trunk, algorithm, alpha, tracker,
                                         fed.gamma))
        draws = [[streams[e.cid].sample_batch(batch, seq)
                  for _ in range(local_steps)] for e in trunk]
        batches.append({name: np.stack([np.stack([d[name] for d in per])
                                        for per in draws])
                        for name in ("tokens", "labels")})   # (C, K, b, S)
    data_s = time.perf_counter() - t0

    step_fn = (dist.make_sfl_step if algorithm == "fedavg"
               else dist.make_csmaafl_step)(cfg, fed, attn_impl=attn_impl,
                                            device=dev)
    losses, step_s = [], []
    for b, c in zip(batches, coefs):
        t0 = time.perf_counter()
        params, metrics = step_fn(params, b, c, fed.lr)
        losses.append(float(metrics["loss"]))      # waits for the step
        step_s.append(time.perf_counter() - t0)
    return SpmdRun(params=params, cids=cids, coefs=coefs, losses=losses,
                   step_s=step_s, data_s=data_s)


def main(argv=None, *, device: DeviceLike = None) -> SpmdRun:
    """The reference's command line (its spmd data plane); runs on the
    card unless ``device`` (a keyword of the function, not a flag) says
    otherwise."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale variant of the arch")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--algorithm", default="csmaafl",
                    choices=["csmaafl", "fedavg"])
    ap.add_argument("--data-plane", default="spmd", dest="data_plane",
                    choices=["spmd", "fleet"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--gamma", type=float, default=0.4,
                    help="eq. (11) γ")
    ap.add_argument("--clients", type=int, default=4,
                    help="simulated clients (folded per fused step)")
    ap.add_argument("--batch", type=int, default=2, help="rows per client")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=5e-3)
    # flags of unported paths: accepted by the parser, refused below
    ap.add_argument("--loop", default="window", choices=["window",
                                                         "compiled"])
    for flag, kw in (("--window-cap", dict(type=int)),
                     ("--sweep", {}), ("--sweep-out", {}),
                     ("--check-parity", dict(type=int)),
                     ("--resume", dict(nargs="?", const="auto")),
                     ("--max-restarts", dict(type=int)),
                     ("--autosave", dict(type=int)), ("--ckpt-dir", {}),
                     ("--keep-last", dict(type=int)), ("--guards", {}),
                     ("--faults", {}), ("--save", {}), ("--config", {})):
        ap.add_argument(flag, default=None, **kw)
    args = ap.parse_args(argv)
    defaults = {"data_plane": "spmd", "loop": "window", "mesh": "host"}
    for name, what in UNPORTED.items():
        if getattr(args, name) != defaults.get(name):
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(f"{flag} {getattr(args, name)} needs "
                                      f"{what}, which the port does not "
                                      f"have yet")

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.arch_id} params={cfg.param_count:,} device={dev} "
          f"algorithm={args.algorithm} data_plane=spmd")
    run = run_spmd(cfg, steps=args.steps, algorithm=args.algorithm,
                   clients=args.clients, batch=args.batch, seq=args.seq,
                   lr=args.lr, gamma=args.gamma, device=dev)
    elapsed = 0.0
    for step, (loss, c, dt) in enumerate(zip(run.losses, run.coefs,
                                             run.step_s)):
        elapsed += dt
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={loss:.4f} c0={float(c[0]):.3f} "
                  f"t={elapsed:.1f}s")
    return run


if __name__ == "__main__":
    main()
