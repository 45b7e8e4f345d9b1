"""A pytest plugin that checks, after every test, that a seeded CPU draw of
reduced qwen2-0.5b parameters is still bitwise what it was at the start
of the session, and that it survives a round trip to the card.

It looks for the process state under which two seeded draws of
``models.transformer.init_params`` could differ (one such failure of
``test_init_params_lands_on_the_card`` is on record).  At session start
it also draws at 1, 2, 4 and 8 intra-op threads.  One JSON line per
check goes to ``$TORCH_CARD_PROBE_OUT`` (default
``build/card_probe.jsonl``):

    PYTHONPATH=tests:src python -m pytest --noconftest -p torch_card_probe \\
        -m gpu tests/test_torch_gpu.py

During ``test_init_params_lands_on_the_card`` it also keeps the host copy
of every draw that goes to the card (the same draw, then the same
copies, as ``init_params`` makes them), and after the test writes one
``"init_test"`` line: the outcome, the intra-op thread count, and per
card draw the leaves where the host copy differs from the session's
reference draw and where the card copy differs from its host copy (so a
failure says whether the host computed differently or the copy to the
card changed the values).  With ``TORCH_CARD_PROBE_INIT_THREADS=n`` the
test runs under ``torch.set_num_threads(n)``.
"""
import json
import os

import pytest
import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.configs.base import get_config
from repro_torch.models import transformer as tmod

_REF = {}
_INIT_TEST = "test_init_params_lands_on_the_card"


def _out_path() -> str:
    return os.environ.get("TORCH_CARD_PROBE_OUT", "build/card_probe.jsonl")


def _draw():
    cfg = get_config("qwen2-0.5b").reduced()
    return leaves(tmod.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu"))


def _differences(draw, ref):
    """[leaf, count, first, last flat index, max |Δ|] per differing leaf."""
    out = []
    for i, (x, y) in enumerate(zip(draw, ref)):
        if not torch.equal(x, y):
            at = (x != y).reshape(-1).nonzero().reshape(-1)
            out.append([i, at.numel(), int(at[0]), int(at[-1]),
                        float((x - y).abs().max())])
    return out


def _write(rec) -> None:
    path = _out_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def pytest_sessionstart(session):
    _REF["draw"] = _draw()
    default = torch.get_num_threads()
    by_threads = {}
    try:
        for n in (1, 2, 4, 8):
            torch.set_num_threads(n)
            by_threads[n] = _differences(_draw(), _REF["draw"])
    finally:
        torch.set_num_threads(default)
    _write({"session": True, "torch": torch.__version__,
            "threads": default, "draws_by_threads": by_threads})


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if item.name != _INIT_TEST:
        yield
        return
    original = tmod.init_params
    kept = []                      # (host leaves, card leaves) per draw

    def traced(cfg, gen, *, dtype=None, device=None):
        dev = tmod.resolve_device(device)
        host = original(cfg, gen, dtype=dtype, device="cpu")
        if dev.type == "cpu":
            return host
        card = tree_map(lambda t: t.to(dev), host)
        kept.append((leaves(host), leaves(card)))
        return card

    default = torch.get_num_threads()
    pin = int(os.environ.get("TORCH_CARD_PROBE_INIT_THREADS", "0"))
    tmod.init_params = traced
    if pin:
        torch.set_num_threads(pin)
    try:
        outcome = yield
    finally:
        tmod.init_params = original
        threads = torch.get_num_threads()
        torch.set_num_threads(default)
    draws = []
    for host, card in kept:
        draws.append({
            "host_vs_reference": _differences(host, _REF["draw"]),
            "card_vs_host": _differences([c.cpu() for c in card], host)})
    _write({"init_test": item.nodeid,
            "passed": outcome.excinfo is None, "threads": threads,
            "pinned": pin, "draws": draws})


def pytest_runtest_teardown(item, nextitem):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    draw = _draw()
    round_trip = None
    if torch.cuda.is_available():
        round_trip = sum(int((x.to("cuda").cpu() != x).sum()) for x in draw)
    _write({"test": item.nodeid, "draw": _differences(draw, _REF["draw"]),
            "round_trip_differing": round_trip})
