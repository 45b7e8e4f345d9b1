"""The port on the card: the CUDA kernel against its plain version, the
engine, and the slice's CPU-vs-card parity.

This file imports neither jax nor ``repro``, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Every test here needs a CUDA card and nvcc; it decides so in a fixture
and skips without them.  Tolerances: f32 1e-6·(1+max|ref|) (summation
order and FMA only), bf16 one bf16 ulp on top of that; runs ≤1e-5 on
the parameters.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.agg_engine import AggEngine
from repro_torch.core.scheduler import make_fleet
from repro_torch.core.tasks import CNNTask
from repro_torch.kernels.weighted_agg import weighted_agg as wa
from repro_torch.kernels.weighted_agg.ref import weighted_agg_ref
from repro_torch.models import cnn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    return torch.device("cuda")


def _assert_close(out, ref):
    diff = (out.float() - ref.float()).abs()
    tol = 1e-6 * (1.0 + float(ref.float().abs().max()))
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
