"""The first slice end to end: FedAvg, CSMAAFL, §III-A α-AFL and the
§III-B baseline through ``repro_torch.api.run`` against ``repro.api.run``.

Both packages get the same task (narrow paper CNN, M=5, 600 samples),
the same fleet and the same initial parameters (the reference's ``w0``,
carried over as numpy).  Times, iterations and βs must be equal, the
accuracy curves must count the same correct predictions, and the final
flat parameters must agree to 1e-5 (f32 rounding of two frameworks'
convolutions, compounded over the run).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.configs.paper_cnn import CNNConfig as JCNNConfig
from repro.core.agg_engine import engine_for as j_engine_for
from repro.core.scheduler import make_fleet as j_make_fleet
from repro.core.tasks import CNNTask as JCNNTask
from repro_torch import api as t_api
from repro_torch._device import resolve_device
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.afl import run_afl
from repro_torch.core.agg_engine import AggEngine
from repro_torch.core.client_plane import ClientPlane
from repro_torch.core.scheduler import make_fleet
from repro_torch.core.sfl import run_fedavg
from repro_torch.core.tasks import CNNTask
from repro_torch.models.cnn import params_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(conv1=4, conv2=8, fc=32)
TASK = dict(iid=False, num_clients=5, train_n=600, test_n=200,
            local_batches_per_step=2)
FLEET = dict(tau=1.0, hetero_a=8.0, seed=0)
TIMING = dict(tau_u=0.05, tau_d=0.05)
# algorithm -> (iterations, eval_every)
RUNS = {"fedavg": (2, 1), "csmaafl": (30, 10), "afl_alpha": (12, 4),
        "afl_baseline": (10, 5)}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tasks():
    jt = JCNNTask(cnn_cfg=JCNNConfig(**NARROW), **TASK)
    tt = CNNTask(cnn_cfg=CNNConfig(**NARROW), device="cpu", **TASK)
    jf = j_make_fleet(5, samples_per_client=jt.num_samples(), **FLEET)
    tf = make_fleet(5, samples_per_client=tt.num_samples(), **FLEET)
    w0 = jt.init_params(0)
    tw0 = params_from_jax({k: np.asarray(v) for k, v in w0.items()}, CPU)
    return jt, tt, jf, tf, w0, tw0


def _unpack(res):
    return res if isinstance(res, tuple) else (res.params, res.history)


def _port_run(tt, tf, tw0, algorithm, **cfg_kw):
    it, ev = RUNS[algorithm]
    cfg = t_api.RunConfig(algorithm=algorithm, iterations=it, eval_every=ev,
                          timing=t_api.TimingConfig(**TIMING), **cfg_kw)
    return t_api.run(tt, cfg, fleet=tf, params0=tw0, eval_fn=tt.eval_fn)


@pytest.mark.parametrize("algorithm", list(RUNS))
def test_slice_matches_reference(tasks, algorithm):
    jt, tt, jf, tf, w0, tw0 = tasks
    it, ev = RUNS[algorithm]
    cfg = j_api.RunConfig(algorithm=algorithm, iterations=it, eval_every=ev,
                          timing=j_api.TimingConfig(**TIMING))
    j_res = j_api.run(jt, cfg, fleet=jf, params0=w0, eval_fn=jt.eval_fn)
    t_res = _port_run(tt, tf, tw0, algorithm)
    (jp, jh), (tp, th) = _unpack(j_res), _unpack(t_res)
    assert th.times == jh.times
    assert th.iterations == jh.iterations
    n_test = TASK["test_n"]
    np.testing.assert_array_equal(np.rint(th.series("accuracy") * n_test),
                                  np.rint(jh.series("accuracy") * n_test))
    if algorithm != "fedavg":
        assert t_res.betas == j_res.betas
        assert [e.cid for e in t_res.events] == [e.cid for e in j_res.events]
        assert t_res.stats["faults"] == j_res.stats["faults"]
    j_flat = np.asarray(j_engine_for(w0).flatten(jp))
    t_flat = AggEngine(tp).flatten(tp).numpy()
    assert float(np.max(np.abs(j_flat - t_flat))) <= 1e-5


@pytest.mark.parametrize("algorithm", ["fedavg", "csmaafl"])
@pytest.mark.parametrize("use_engine", [True, False])
def test_per_leaf_paths_match_plane(tasks, algorithm, use_engine):
    """plane.kind='none': the per-minibatch loop with the flat-buffer
    engine or leaf by leaf, against the fleet plane."""
    _, tt, _, tf, _, tw0 = tasks
    plane = _unpack(_port_run(tt, tf, tw0, algorithm))
    flat = _unpack(_port_run(tt, tf, tw0, algorithm,
                             plane=t_api.PlaneConfig(kind="none"),
                             use_engine=use_engine))
    assert plane[1].times == flat[1].times
    eng = AggEngine(tw0)
    diff = (eng.flatten(plane[0]) - eng.flatten(flat[0])).abs().max()
    assert float(diff) <= 1e-5


def _toy(M, D, use_plane):
    """Seed-independent local data, so FedAvg rounds and baseline cycles
    see the same client updates (§III-B needs it)."""
    rng = np.random.default_rng(5)
    targets = rng.normal(size=(M, D)).astype(np.float32)
    w0 = {"w": torch.from_numpy(rng.normal(size=D).astype(np.float32))}
    fleet = make_fleet(M, tau=1.0, hetero_a=4.0,
                       samples_per_client=[60 + 20 * m for m in range(M)],
                       adaptive=False, seed=0)

    def batch_fn(cid, num_steps, seed):
        return np.broadcast_to(targets[cid], (num_steps, D)).copy()

    def step(flat, t):
        return flat - 0.2 * (flat - t)

    if use_plane:
        plane = ClientPlane(AggEngine(w0), fleet, step, batch_fn,
                            device=CPU)
        return w0, fleet, None, plane

    def local_train(params, cid, steps, seed):
        w = params["w"]
        for t in batch_fn(cid, steps, seed):
            w = step(w, torch.from_numpy(t))
        return {"w": w}

    return w0, fleet, local_train, None


@pytest.mark.parametrize("use_plane", [True, False])
@pytest.mark.parametrize("M,cycles", [(4, 2), (7, 1)])
def test_baseline_equals_fedavg_every_M(use_plane, M, cycles):
    """§III-B: M baseline-AFL uploads reproduce one FedAvg round."""
    w0, fleet, local_train, plane = _toy(M, 41, use_plane)
    kw = dict(tau_u=0.2, tau_d=0.1, client_plane=plane)
    w_sfl, _ = run_fedavg(w0, fleet, local_train, rounds=cycles, **kw)
    res = run_afl(w0, fleet, local_train, algorithm="afl_baseline",
                  iterations=cycles * M, **kw)
    assert float((w_sfl["w"] - res.params["w"]).abs().max()) <= 1e-5


def test_train_row_matches_train_rows():
    """A single-row retrain (eq. 4) writes what the event-window form
    writes, in place, and leaves the other rows alone."""
    w0, fleet, _, plane = _toy(4, 9, True)
    g = plane.engine.flatten(w0)
    a = plane.init_fleet(g, seed=0)
    b = a.clone()
    before = a.clone()
    assert plane.train_row(a, g * 2, 2, 3, 7) is a
    plane.train_rows(b, [(2, g * 2, 3, 7)])
    assert torch.equal(a, b)
    assert torch.equal(a[[0, 1, 3]], before[[0, 1, 3]])
    assert not torch.equal(a[2], before[2])
    with pytest.raises(ValueError):
        plane.train_rows(b, [(1, g, 1, 0), (1, g, 1, 1)])


def test_batch_indices_equal_reference(tasks):
    """The staged minibatch indices both packages train on."""
    jt, tt, *_ = tasks
    for cid in range(5):
        for steps, seed in ((1, 0), (3, 100003 * 2 + 7)):
            np.testing.assert_array_equal(
                tt._global_batch_indices(cid, steps, seed),
                jt._global_batch_indices(cid, steps, seed))


def test_unported_options_raise():
    bad = [dict(loop="compiled"), dict(faults="lossy"), dict(guards=True),
           dict(server_opt=t_api.ServerOptConfig(name="adam")),
           dict(autosave=t_api.AutosaveConfig(every=4, dir="ckpt")),
           dict(plane=t_api.PlaneConfig(kind="sharded")),
           dict(plane=t_api.PlaneConfig(store="paged")),
           dict(plane=t_api.PlaneConfig(active_slots=4)),
           dict(plane=t_api.PlaneConfig(prefetch_depth=3)),
           dict(time_scale=0.01)]
    for kw in bad:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_api.run(None, t_api.RunConfig(**kw))
    w0, fleet, _, plane = _toy(3, 5, True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_afl(w0, fleet, None, algorithm="csmaafl", iterations=3,
                tau_u=0.1, tau_d=0.1, client_plane=plane,
                compiled_loop=True)
    fleet[0].batch_size = 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ClientPlane(plane.engine, fleet, plane.step_fn, plane.batch_fn,
                    device=CPU)


def test_no_card_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        CNNTask(train_n=20, test_n=10, num_clients=2)
    assert resolve_device("cpu") == CPU


def test_port_imports_neither_jax_nor_reference():
    """Import every module of repro_torch and chip_smoke.py in a fresh
    interpreter: no jax, no repro."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location(\n"
        f"    'chip_smoke', {os.path.join(ROOT, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 20, mods\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a card the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
