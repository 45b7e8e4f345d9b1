"""Run API: one typed ``RunConfig`` + one ``run(task, config)`` facade.

Twin of ``repro/api.py``: the same dataclass tree, field names and
defaults, so a run reads the same in either package.  This slice runs the
windowed loop (``loop="windowed"``) on the dense single-device plane
(``plane.kind="single"``) or without a plane (``"none"``); every other
value raises ``NotImplementedError`` naming its ROADMAP item.  JSON
round-trips, presets and the CLI flag groups come with ROADMAP Queue 1 #8.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

ALGORITHMS = ("csmaafl", "afl_alpha", "afl_baseline", "fedavg")
LOOPS = ("windowed", "compiled", "async", "ingest")


@dataclass(frozen=True)
class TimingConfig:
    """Paper timing constants: uplink / downlink transfer times (s)."""
    tau_u: float = 0.1
    tau_d: float = 0.1


@dataclass(frozen=True)
class ServerOptConfig:
    """Server-side optimizer on the blended delta (FedOpt);
    ``name=None`` is the paper's plain blend."""
    name: Optional[str] = None
    lr: float = 1.0


@dataclass(frozen=True)
class AutosaveConfig:
    """Crash-safe autosave cadence; ``every=None`` off."""
    every: Optional[int] = None
    dir: Optional[str] = None
    keep_last: int = 3


@dataclass(frozen=True)
class PlaneConfig:
    """Client-plane selection: ``none`` (per-leaf reference loop),
    ``single`` (the (M, n) fleet buffer), ``sharded`` (fleet mesh).
    ``window_cap`` bounds the AFL event window before a forced retrain
    flush.  ``store`` picks dense or paged fleet rows."""
    kind: str = "single"
    window_cap: Optional[int] = None
    store: str = "dense"
    active_slots: Optional[int] = None
    prefetch_depth: int = 2

    def __post_init__(self):
        if self.kind not in ("none", "single", "sharded"):
            raise ValueError(f"plane.kind must be none|single|sharded, "
                             f"got '{self.kind}'")
        if self.store not in ("dense", "paged"):
            raise ValueError(f"plane.store must be dense|paged, "
                             f"got '{self.store}'")
        if self.active_slots is not None and self.active_slots < 1:
            raise ValueError("plane.active_slots must be >= 1")
        if self.prefetch_depth < 1:
            raise ValueError("plane.prefetch_depth must be >= 1")


@dataclass(frozen=True)
class FleetConfig:
    """Fleet geometry for ``scheduler.make_fleet`` (paper §V: compute
    time log-uniform in [tau, hetero_a·tau])."""
    num_clients: int = 16
    tau: float = 1.0
    hetero_a: float = 4.0
    adaptive: bool = True
    min_steps: int = 1
    max_steps: int = 8
    base_local_steps: int = 1
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    """Everything a run needs besides the task and the device state.
    ``iterations`` is rounds for fedavg and events for the AFL loops."""
    algorithm: str = "csmaafl"
    loop: str = "windowed"
    iterations: int = 100
    gamma: float = 0.4
    mu_momentum: float = 0.9
    eval_every: int = 10
    evaluate: bool = False
    max_staleness: Optional[int] = None
    local_steps_override: Optional[int] = None   # fedavg: force uniform K
    time_scale: float = 0.005                    # async loop wall-clock scale
    use_engine: bool = True
    seed: int = 0
    timing: TimingConfig = field(default_factory=TimingConfig)
    server_opt: ServerOptConfig = field(default_factory=ServerOptConfig)
    autosave: AutosaveConfig = field(default_factory=AutosaveConfig)
    plane: PlaneConfig = field(default_factory=PlaneConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    faults: Any = None
    guards: Any = None
    ingest: Any = None

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, "
                             f"got '{self.algorithm}'")
        if self.loop not in LOOPS:
            raise ValueError(f"loop must be one of {LOOPS}, "
                             f"got '{self.loop}'")

    def check_supported(self) -> None:
        """Raise ``NotImplementedError`` for what this slice does not run."""
        todo = []
        if self.loop != "windowed":
            todo.append(f"loop='{self.loop}' (ROADMAP Queue 1 #6, #11)")
        if self.plane.kind == "sharded":
            todo.append("plane.kind='sharded' (ROADMAP Queue 1 #14)")
        if self.plane.store != "dense":
            todo.append("plane.store='paged' (ROADMAP Queue 1 #10)")
        if self.plane.active_slots is not None or \
                self.plane.prefetch_depth != PlaneConfig.prefetch_depth:
            todo.append("plane.active_slots / plane.prefetch_depth of the "
                        "paged store (ROADMAP Queue 1 #10)")
        if self.time_scale != RunConfig.time_scale:
            todo.append("time_scale of the async loop (ROADMAP Queue 1 #11)")
        if self.server_opt.name is not None:
            todo.append("server_opt (ROADMAP Queue 1 #6)")
        if self.autosave.every is not None or self.autosave.dir is not None:
            todo.append("autosave (ROADMAP Queue 1 #7)")
        for name in ("faults", "guards", "ingest"):
            if getattr(self, name) is not None:
                todo.append(f"{name} (ROADMAP Queue 1 #7, #11)")
        if todo:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(todo))

    def afl_kwargs(self) -> Dict[str, Any]:
        """The keyword set of ``core.afl.run_afl``."""
        return dict(
            algorithm=self.algorithm, iterations=self.iterations,
            tau_u=self.timing.tau_u, tau_d=self.timing.tau_d,
            gamma=self.gamma, mu_momentum=self.mu_momentum,
            eval_every=self.eval_every, max_staleness=self.max_staleness,
            use_engine=self.use_engine,
            use_client_plane=self.plane.kind != "none", seed=self.seed)

    def fedavg_kwargs(self) -> Dict[str, Any]:
        """The keyword set of ``core.sfl.run_fedavg``."""
        return dict(
            rounds=self.iterations, tau_u=self.timing.tau_u,
            tau_d=self.timing.tau_d, eval_every=self.eval_every,
            local_steps_override=self.local_steps_override,
            use_engine=self.use_engine,
            use_client_plane=self.plane.kind != "none", seed=self.seed)


def run(task, config: RunConfig, *, fleet=None, client_plane=None,
        params0=None, eval_fn=None, local_train_fn=None):
    """Run ``config`` against ``task``: build the fleet (``make_fleet``
    over the task's sample counts), the client plane (per
    ``config.plane``) and the eval hook (``task.eval_fn`` when
    ``config.evaluate``), then dispatch on ``algorithm``.  Any runtime
    object can be passed in to override the task-derived one.  Returns an
    ``AFLResult`` for the AFL loops and ``(params, history)`` for fedavg.
    """
    cfg = config
    cfg.check_supported()
    if fleet is None:
        from repro_torch.core.scheduler import make_fleet
        fc = cfg.fleet
        fleet = make_fleet(fc.num_clients, tau=fc.tau,
                           hetero_a=fc.hetero_a,
                           samples_per_client=task.num_samples(),
                           seed=fc.seed, adaptive=fc.adaptive,
                           min_steps=fc.min_steps, max_steps=fc.max_steps,
                           base_local_steps=fc.base_local_steps)
    if params0 is None:
        params0 = task.init_params(cfg.seed)
    use_plane = cfg.plane.kind != "none"
    if client_plane is None and use_plane:
        client_plane = task.client_plane(fleet)
    if client_plane is not None and cfg.plane.window_cap is not None:
        client_plane.window_cap = cfg.plane.window_cap
    if eval_fn is None and cfg.evaluate:
        eval_fn = task.eval_fn
    if local_train_fn is None and not use_plane:
        local_train_fn = task.local_train_fn

    if cfg.algorithm == "fedavg":
        from repro_torch.core import sfl
        return sfl.run_fedavg(params0, fleet, local_train_fn,
                              eval_fn=eval_fn, client_plane=client_plane,
                              **cfg.fedavg_kwargs())
    from repro_torch.core import afl
    return afl.run_afl(params0, fleet, local_train_fn, eval_fn=eval_fn,
                       client_plane=client_plane, **cfg.afl_kwargs())
