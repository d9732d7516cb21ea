"""The synthetic CIFAR-10 training split, made from the run's seed, in the
CIFAR-10 python files the program reads, and the reference's augmented
batches of it.

``synthetic_split`` is the recipe of the port's
``data/cifar10.py::_synthetic_split``, copied: class-templated noisy
32x32x3 uint8 images with CIFAR-10's shapes and cardinalities, the
templates fixed.  Its draws come from a ``torch.Generator`` seeded with
``seed`` on the device that makes the split, in a few large calls (the
NumPy original takes seconds of host time for 50,000 images); so a seed
gives the same split on the same kind of device.  The training split
takes ``seed``, the test split ``seed + 1``.

An example is an image; a reference batch is the pad-4 crop, flip and
normalization of ``reference/augment.py`` keyed by (seed, rank, epoch 0,
step), with the class labels.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import data
from portbench.reference import augment

NUM_CLASSES = 10

# The recipe's knobs, as the port's copy has them.
_TEMPLATES_PER_CLASS = 3
_NOISE = 0.7
_SHARED = 0.55
_CONTRAST = 0.5
_LABEL_NOISE = 0.1


def _class_templates() -> np.ndarray:
    rng = np.random.default_rng(42)
    base = rng.uniform(40, 215, size=(1, 1, 4, 4, 3)).astype(np.float32)
    cls = rng.uniform(40, 215,
                      size=(NUM_CLASSES, 1, 4, 4, 3)).astype(np.float32)
    var = rng.uniform(40, 215,
                      size=(NUM_CLASSES, _TEMPLATES_PER_CLASS, 4, 4, 3)
                      ).astype(np.float32)
    small = _SHARED * base + (1 - _SHARED) * (0.65 * cls + 0.35 * var)
    return np.repeat(np.repeat(small, 8, axis=2), 8, axis=3)


def synthetic_split(n: int, seed: int, device="cpu") -> data.Split:
    """``n`` images and labels drawn from ``seed`` (any non-negative int)
    on ``device``, returned on the host."""
    gen = torch.Generator(device).manual_seed(seed)
    templates = torch.from_numpy(_class_templates()).to(device)
    labels = torch.randint(0, NUM_CLASSES, (n,), generator=gen,
                           device=device)
    tidx = torch.randint(0, _TEMPLATES_PER_CLASS, (n,), generator=gen,
                         device=device)
    noise = torch.rand((n, 32, 32, 3), generator=gen, device=device) * 255
    images = (1 - _NOISE) * templates[labels, tidx] + _NOISE * noise
    images = 127.5 + _CONTRAST * (images - 127.5)
    flip = torch.rand((n,), generator=gen, device=device) < _LABEL_NOISE
    labels = torch.where(flip, torch.randint(0, NUM_CLASSES, (n,),
                                             generator=gen, device=device),
                         labels)
    images = images.clamp(0, 255).to(torch.uint8)
    return data.Split(images.cpu().numpy(),
                      labels.to(torch.int32).cpu().numpy())


def make(dataset: dict, seed: int, data_dir: str, device) -> None:
    data.write_cifar10(
        data_dir, synthetic_split(dataset["train_images"], seed, device),
        synthetic_split(dataset["test_images"], seed + 1, device))


def examples(dataset: dict) -> int:
    return dataset["train_images"]


def read(data_dir: str) -> data.Split:
    return data.read_cifar10(data_dir)


def batch(split: data.Split, rows: np.ndarray, traffic: dict, seed: int,
          rank: int, step: int, device):
    if not traffic["augment"]:
        raise ValueError("cifar10_synthetic's reference batches are "
                         "augmented: the traffic must set augment true")
    x = augment.transform(split.images[rows], seed, rank, 0, step, device)
    y = torch.from_numpy(split.labels[rows].astype(np.int64)).to(device)
    return x, y
