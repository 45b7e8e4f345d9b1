"""The paper's CNN (Section IV): 2 conv + 2 maxpool + 2 FC, ReLU, log-softmax.

Twin of ``repro/models/cnn.py``.  Parameters keep the reference's layout —
conv weights HWIO, images NHWC, ``fc1_w`` rows in NHWC-flatten order — so
a parameter dict carries over between the packages unchanged
(``params_from_jax``).  ``forward`` permutes to torch's NCHW/OIHW inside
and back to NHWC before ``fc1``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNConfig

Params = Dict[str, torch.Tensor]


def init_params(cfg: CNNConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    """He-normal weights, zero biases — the reference's distribution (its
    ``jax.random`` draws cannot be reproduced in torch)."""
    ksz, c1, c2 = cfg.kernel, cfg.conv1, cfg.conv2
    # after two stride-2 maxpools with SAME conv: size/4
    flat = (cfg.image_size // 4) ** 2 * c2

    def he(shape, fan_in):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * math.sqrt(2.0 / fan_in))

    params = {
        "conv1_w": he((ksz, ksz, cfg.channels, c1), ksz * ksz * cfg.channels),
        "conv1_b": torch.zeros(c1),
        "conv2_w": he((ksz, ksz, c1, c2), ksz * ksz * c1),
        "conv2_b": torch.zeros(c2),
        "fc1_w": he((flat, cfg.fc), flat),
        "fc1_b": torch.zeros(cfg.fc),
        "fc2_w": he((cfg.fc, cfg.num_classes), cfg.fc),
        "fc2_b": torch.zeros(cfg.num_classes),
    }
    return {k: v.to(device) for k, v in params.items()}


def params_from_jax(np_params: Mapping[str, np.ndarray],
                    device) -> Params:
    """Carry the reference's parameters (as numpy, same names and shapes)
    into the port, values unchanged."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in np_params.items()}


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor
          ) -> torch.Tensor:
    # HWIO -> OIHW; "same" pads (k-1)/2 on each side for the odd kernel,
    # as XLA's SAME does
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b, padding="same")


def forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) -> log-probs (B, num_classes)."""
    x = images.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    x = F.relu(_conv(x, params["conv1_w"], params["conv1_b"]))
    x = F.max_pool2d(x, 2, 2)
    x = F.relu(_conv(x, params["conv2_w"], params["conv2_b"]))
    x = F.max_pool2d(x, 2, 2)
    # the reference flattens NHWC: back to NHWC first, or every fc1_w row
    # would weigh a different pixel
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1_w"] + params["fc1_b"])
    logits = x @ params["fc2_w"] + params["fc2_b"]
    return F.log_softmax(logits, dim=-1)


def loss_fn(params: Params, batch: Mapping[str, torch.Tensor]
            ) -> torch.Tensor:
    """NLL loss on log-softmax outputs."""
    logp = forward(params, batch["images"])
    labels = batch["labels"].long()
    return -logp.gather(1, labels[:, None])[:, 0].mean()


def accuracy(params: Params, images: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
    logp = forward(params, images)
    return (logp.argmax(-1) == labels).float().mean()
