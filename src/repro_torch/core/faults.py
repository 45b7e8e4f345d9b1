"""What the windowed loop reads of the fault plane (twin of part of
``repro/core/faults.py``): the outcome codes, ``participation_stats``
and a ``resolve_faults`` that accepts only a clean run.

Fault injection itself (availability windows, mid-flight drops, flaky
uplinks realized as a host-side trace transform) is not ported yet; see
ROADMAP Queue 1 #7.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

# UploadEvent.outcome codes
OUTCOME_OK = 0
OUTCOME_UNAVAIL = 1          # offline past the timeout at upload start
OUTCOME_MIDFLIGHT = 2        # went offline between download and upload
OUTCOME_LOSS = 3             # uplink lost every attempt up to max_retries
OUTCOME_TIMEOUT = 4          # accumulated retry delay exceeded the timeout
OUTCOME_SHED = 5             # shed at the ingest admission queue
OUTCOME_NAMES = {
    OUTCOME_OK: "ok",
    OUTCOME_UNAVAIL: "drop_unavail",
    OUTCOME_MIDFLIGHT: "drop_midflight",
    OUTCOME_LOSS: "drop_loss",
    OUTCOME_TIMEOUT: "drop_timeout",
    OUTCOME_SHED: "drop_shed",
}


def resolve_faults(spec) -> None:
    """Only the clean timeline (``None``) is supported by the port."""
    if spec is not None:
        raise NotImplementedError(
            "fault injection is not ported yet (ROADMAP Queue 1 #7: "
            "faults, guards, presets, checkpoints)")
    return None


def gini(x) -> float:
    """Gini index of a nonnegative vector (0 = equal shares)."""
    x = np.sort(np.asarray(x, np.float64))
    n = x.size
    s = float(x.sum())
    if n == 0 or s <= 0.0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2.0 * float(cum.sum()) / s) / n)


def participation_stats(cids, betas, dropped, stale_drop, M: int, *,
                        attempts=None, outcomes=None,
                        staleness=None) -> Dict[str, Any]:
    """Per-run participation accounting: an event participates only if it
    was neither fault-dropped nor ``max_staleness``-dropped;
    ``contribution`` weighs each accepted event by its (1−β) mass."""
    cids = np.asarray(cids, np.int64)
    betas = np.asarray(betas, np.float64)
    E = len(cids)
    dropped = (np.zeros(E, bool) if dropped is None
               else np.asarray(dropped, bool))
    stale_drop = (np.zeros(E, bool) if stale_drop is None
                  else np.asarray(stale_drop, bool))
    accepted = ~dropped & ~stale_drop
    part = np.bincount(cids[accepted], minlength=M)
    contrib = np.zeros(M, np.float64)
    np.add.at(contrib, cids[accepted], 1.0 - betas[accepted])
    stats: Dict[str, Any] = {
        "events": E,
        "accepted": int(accepted.sum()),
        "fault_drops": int(dropped.sum()),
        "stale_drops": int((stale_drop & ~dropped).sum()),
        "drop_rate": float((~accepted).mean()) if E else 0.0,
        "participation": part.tolist(),
        "participation_min": int(part.min()) if M else 0,
        "contribution_gini": gini(contrib),
    }
    if attempts is not None:
        stats["mean_attempts"] = float(np.mean(attempts)) if E else 1.0
    if outcomes is not None:
        codes, counts = np.unique(np.asarray(outcomes), return_counts=True)
        stats["outcomes"] = {OUTCOME_NAMES[int(c)]: int(n)
                             for c, n in zip(codes, counts)}
    if staleness is not None and E:
        st = np.asarray(staleness, np.float64)
        stats["realized_staleness_mean"] = float(st.mean())
        stats["realized_staleness_max"] = int(st.max())
    return stats
