"""Procedural MNIST-like dataset (offline stand-in for MNIST/Fashion-MNIST).

Twin of ``repro/data/mnist_like.py``: the same numpy draws in the same
order, so both packages see bit-equal arrays for a given (variant, seed).
Each class is a smooth random "stroke field" template; samples are random
shifts, amplitude scaling and pixel noise of their class template.

  * ``make_dataset("digits")``   — MNIST stand-in (sharper templates)
  * ``make_dataset("fashion")``  — Fashion stand-in (smoother, harder)
"""
from __future__ import annotations

import dataclasses

import numpy as np

IMAGE_SIZE = 28
NUM_CLASSES = 10


def _smooth(img: np.ndarray, iters: int) -> np.ndarray:
    for _ in range(iters):
        img = (img
               + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    return img


def _class_template(cls: int, variant: str) -> np.ndarray:
    rng = np.random.default_rng(1000 + cls)
    img = rng.normal(0, 1, (IMAGE_SIZE, IMAGE_SIZE))
    img = _smooth(img, 3 if variant == "digits" else 6)
    # threshold into stroke-like structures
    q = np.quantile(img, 0.72)
    img = np.where(img > q, 1.0, 0.0)
    img = _smooth(img, 1)
    return img.astype(np.float32)


@dataclasses.dataclass
class Dataset:
    train_x: np.ndarray   # (N, 28, 28, 1) float32 in [0,1]
    train_y: np.ndarray   # (N,) int32
    test_x: np.ndarray
    test_y: np.ndarray


def _render(templates: np.ndarray, labels: np.ndarray,
            rng: np.random.Generator, noise: float) -> np.ndarray:
    n = len(labels)
    out = np.empty((n, IMAGE_SIZE, IMAGE_SIZE, 1), np.float32)
    shifts = rng.integers(-3, 4, size=(n, 2))
    scales = rng.uniform(0.7, 1.3, size=n)
    for k in range(n):
        img = templates[labels[k]]
        img = np.roll(img, shifts[k][0], axis=0)
        img = np.roll(img, shifts[k][1], axis=1)
        img = img * scales[k] + rng.normal(0, noise, img.shape)
        out[k, :, :, 0] = img
    return np.clip(out, 0.0, 1.5)


def make_dataset(variant: str = "digits", *, train_n: int = 60000,
                 test_n: int = 10000, seed: int = 0) -> Dataset:
    """Deterministic given (variant, seed); sizes match MNIST by default."""
    if variant not in ("digits", "fashion"):
        raise ValueError(f"variant must be digits|fashion, got '{variant}'")
    templates = np.stack([_class_template(c, variant)
                          for c in range(NUM_CLASSES)])
    noise = 0.20 if variant == "digits" else 0.30
    rng = np.random.default_rng(seed + (0 if variant == "digits" else 77))
    train_y = rng.integers(0, NUM_CLASSES, train_n).astype(np.int32)
    test_y = rng.integers(0, NUM_CLASSES, test_n).astype(np.int32)
    train_x = _render(templates, train_y, rng, noise)
    test_x = _render(templates, test_y, rng, noise)
    return Dataset(train_x, train_y, test_x, test_y)
