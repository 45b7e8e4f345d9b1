"""The port's paper CNN against ``repro.models.cnn`` on a narrow config.

Log-probs, loss, gradient, one SGD step and accuracy agree to 1e-5 on
the same parameters and images (numpy from one seed).  The gradient and
step checks catch a flatten in the wrong layout before ``fc1``: shapes
would still match, every ``fc1_w`` row would weigh another pixel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as JCNNConfig
from repro.models import cnn as j_cnn
from repro_torch.configs.paper_cnn import FASHION_CNN, MNIST_CNN, CNNConfig
from repro_torch.models import cnn as t_cnn

torch.set_num_threads(2)

NARROW = dict(conv1=4, conv2=8, fc=32)
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    w0 = jax.jit(j_cnn.init_params, static_argnums=0)(JCNNConfig(**NARROW),
                                                      jax.random.PRNGKey(1))
    params = {k: np.asarray(v) for k, v in w0.items()}
    # biases off zero so their gradients and the bias adds are exercised
    for k in ("conv1_b", "conv2_b", "fc1_b", "fc2_b"):
        params[k] = rng.normal(0, 0.1, params[k].shape).astype(np.float32)
    images = rng.uniform(0, 1.5, (6, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    t_params = t_cnn.params_from_jax(params, "cpu")
    j_batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    t_batch = {"images": torch.from_numpy(images),
               "labels": torch.from_numpy(labels).long()}
    return j_params, t_params, j_batch, t_batch


def test_config_matches_reference():
    assert dataclasses.asdict(MNIST_CNN) == dataclasses.asdict(JCNNConfig())
    assert dataclasses.asdict(FASHION_CNN) == \
        dataclasses.asdict(JCNNConfig(fc=1024))


def test_log_probs_and_loss_match(setup):
    jp, tp, jb, tb = setup
    np.testing.assert_allclose(
        t_cnn.forward(tp, tb["images"]).numpy(),
        np.asarray(jax.jit(j_cnn.forward)(jp, jb["images"])), atol=TOL)
    np.testing.assert_allclose(float(t_cnn.loss_fn(tp, tb)),
                               float(jax.jit(j_cnn.loss_fn)(jp, jb)),
                               atol=TOL)
    assert float(t_cnn.accuracy(tp, tb["images"], tb["labels"])) == \
        float(j_cnn.accuracy(jp, jb["images"], jb["labels"]))


def test_gradient_and_sgd_step_match(setup):
    jp, tp, jb, tp_batch = setup
    jg = jax.jit(jax.grad(j_cnn.loss_fn))(jp, jb)
    tg = torch.func.grad(t_cnn.loss_fn)(tp, tp_batch)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=TOL, err_msg=k)
    lr = 0.05
    j_new = {k: jp[k] - lr * jg[k] for k in jp}
    t_new = {k: tp[k] - lr * tg[k] for k in tp}
    np.testing.assert_allclose(
        t_cnn.forward(t_new, tp_batch["images"]).numpy(),
        np.asarray(jax.jit(j_cnn.forward)(j_new, jb["images"])), atol=TOL)


def test_init_params_shapes_and_distribution():
    cfg = CNNConfig(**NARROW)
    p = t_cnn.init_params(cfg, torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda: j_cnn.init_params(JCNNConfig(**NARROW),
                                                   jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in p.values())
    fan_in = 7 * 7 * cfg.conv2
    std = float(p["fc1_w"].std())
    assert abs(std - np.sqrt(2.0 / fan_in)) < 0.05 * np.sqrt(2.0 / fan_in)
    assert float(p["fc1_b"].abs().max()) == 0.0
    # same seed, same draw
    q = t_cnn.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], q[k]) for k in p)
