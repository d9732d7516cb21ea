"""The CIFAR-10 python files, the image format the program loads through
its public ``data_dir``: ``write_cifar10`` writes a split in the
``cifar-10-batches-py`` pickle format (five training batches and a test
batch, each image as 3072 bytes of planar channels); ``read_cifar10``
reads the training split back for the reference.  An image recipe
(``recipes/``) makes the split and writes it with these.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np

TRAIN_FILES = tuple(f"data_batch_{i}" for i in range(1, 6))
TEST_FILE = "test_batch"


class Split(NamedTuple):
    images: np.ndarray  # [N,32,32,3] uint8
    labels: np.ndarray  # [N] int32


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
