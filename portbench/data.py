"""The training split, made from the run's seed, and its CIFAR-10 python
files for the program.

``synthetic_split`` is the recipe of the port's
``data/cifar10.py::_synthetic_split``, copied: class-templated noisy
32x32x3 uint8 images with CIFAR-10's shapes and cardinalities, the
templates fixed.  Its draws come from a ``torch.Generator`` seeded with
``seed`` on the device that makes the split, in a few large calls (the
NumPy original takes seconds of host time for 50,000 images); so a seed
gives the same split on the same kind of device.  ``write_cifar10`` writes a
split in the ``cifar-10-batches-py`` pickle format (five training batches
and a test batch, each image as 3072 bytes of planar channels), which the
program loads through its public ``data_dir``; ``read_cifar10`` reads the
same files back for the reference.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

NUM_CLASSES = 10
TRAIN_FILES = tuple(f"data_batch_{i}" for i in range(1, 6))
TEST_FILE = "test_batch"

# The recipe's knobs, as the port's copy has them.
_TEMPLATES_PER_CLASS = 3
_NOISE = 0.7
_SHARED = 0.55
_CONTRAST = 0.5
_LABEL_NOISE = 0.1


class Split(NamedTuple):
    images: np.ndarray  # [N,32,32,3] uint8
    labels: np.ndarray  # [N] int32


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


def synthetic_split(n: int, seed: int, device="cpu") -> Split:
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
    return Split(images.cpu().numpy(),
                 labels.to(torch.int32).cpu().numpy())


def _write_batch(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    planar = np.ascontiguousarray(images.transpose(0, 3, 1, 2)).reshape(
        len(images), -1)
    with open(path, "wb") as f:
        pickle.dump({b"data": planar, b"labels": labels.tolist()}, f,
                    protocol=4)


def write_cifar10(data_dir: str, train: Split, test: Split) -> str:
    """Write ``train`` (in five equal batches) and ``test`` under
    ``data_dir/cifar-10-batches-py``; returns ``data_dir``."""
    batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
    os.makedirs(batch_dir, exist_ok=True)
    n = len(train.labels)
    bounds = np.linspace(0, n, len(TRAIN_FILES) + 1).astype(int)
    for name, lo, hi in zip(TRAIN_FILES, bounds[:-1], bounds[1:]):
        _write_batch(os.path.join(batch_dir, name), train.images[lo:hi],
                     train.labels[lo:hi])
    _write_batch(os.path.join(batch_dir, TEST_FILE), test.images,
                 test.labels)
    return data_dir


def read_cifar10(data_dir: str) -> Split:
    """The training split of ``write_cifar10``'s files, NHWC uint8."""
    batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
    imgs, labs = [], []
    for name in TRAIN_FILES:
        with open(os.path.join(batch_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labs.append(np.asarray(d[b"labels"], np.int32))
    return Split(np.ascontiguousarray(np.concatenate(imgs)),
                 np.concatenate(labs))
