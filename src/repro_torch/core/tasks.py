"""Task harness: binds the paper's CNN and dataset to the FL loops.

Twin of ``CNNTask`` in ``repro/core/tasks.py`` (``LMTask`` comes with the
LM-stack slice).  The whole training set lives on the device once and
minibatches are gathered by index inside the step, so no image tensor
crosses host→device in the training loop.  Two local-training surfaces:

* ``local_train_fn`` — the per-minibatch reference path over a parameter
  dict;
* ``client_plane(fleet)`` — the fleet plane: the SGD step is
  ``flat − lr·∇loss(unflatten(flat))`` on the flat parameter vector, the
  gradient taken by ``torch.func.grad`` through views into the row.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device, to_device
from repro_torch.configs.paper_cnn import MNIST_CNN, CNNConfig
from repro_torch.data import federated as fd
from repro_torch.data.mnist_like import make_dataset
from repro_torch.models import cnn as cnn_mod


class CNNTask:
    def __init__(self, *, variant: str = "digits", iid: bool = True,
                 num_clients: int = 100, train_n: int = 60000,
                 test_n: int = 10000, batch_size: int = 5, lr: float = 0.01,
                 local_batches_per_step: int = 8,
                 cnn_cfg: Optional[CNNConfig] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        # full-f32 convs and matmuls, as the reference computes them:
        # cuDNN convolutions default to TF32, which alone breaks the
        # ≤1e-5 parity.  These switches are process-wide.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cnn_cfg or MNIST_CNN
        self.lr = lr
        self.batch_size = batch_size
        self.local_batches = local_batches_per_step
        ds = make_dataset(variant, train_n=train_n, test_n=test_n, seed=seed)
        parts = fd.partition("iid" if iid else "label", ds.train_y,
                             num_clients, seed=seed,
                             **({} if iid else {"classes_per_client": 2}))
        self.clients = fd.make_clients(ds.train_x, ds.train_y, parts)
        dev = self.device
        self._train_x = to_device(ds.train_x, dev)
        self._train_y = to_device(ds.train_y, dev, torch.int64)
        self.test_x = to_device(ds.test_x, dev)
        self.test_y = to_device(ds.test_y, dev, torch.int64)

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        gen = torch.Generator().manual_seed(seed)
        return cnn_mod.init_params(self.cfg, gen, self.device)

    def num_samples(self) -> List[int]:
        return [c.num_samples for c in self.clients]

    def _global_batch_indices(self, cid: int, num_steps: int, seed: int
                              ) -> np.ndarray:
        """(num_batches, B) indices into the staged full training set."""
        client = self.clients[cid]
        local = client.batch_indices(self.batch_size,
                                     num_steps * self.local_batches, seed)
        return client.indices[local].astype(np.int64)

    def _batch(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"images": self._train_x[idx], "labels": self._train_y[idx]}

    def local_train_fn(self, params, cid: int, num_steps: int, seed: int):
        """K "local iterations"; each = ``local_batches`` SGD minibatches.
        Per-minibatch reference path over the parameter dict."""
        idx = to_device(self._global_batch_indices(cid, num_steps, seed),
                        self.device)
        grad_fn = torch.func.grad(cnn_mod.loss_fn)
        for row in idx:
            grads = grad_fn(params, self._batch(row))
            params = {k: p - self.lr * grads[k] for k, p in params.items()}
        return params

    def client_plane(self, fleet):
        """The dense fleet plane: SGD against the flat parameter vector,
        batches staged as index arrays (the image gather happens on the
        device).  The sharded and paged planes are not ported yet."""
        from repro_torch.core.agg_engine import engine_for
        from repro_torch.core.client_plane import ClientPlane

        template = cnn_mod.init_params(self.cfg, torch.Generator())
        engine = engine_for(template)
        unflatten = engine.unflatten
        lr = self.lr

        def step_fn(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
            batch = self._batch(idx)

            def loss_flat(f):
                return cnn_mod.loss_fn(unflatten(f), batch)

            return flat - lr * torch.func.grad(loss_flat)(flat)

        return ClientPlane(engine, fleet, step_fn,
                           self._global_batch_indices, device=self.device)

    def eval_fn(self, params) -> Dict[str, float]:
        with torch.no_grad():
            acc = cnn_mod.accuracy(params, self.test_x, self.test_y)
        return {"accuracy": float(acc)}
