"""CIFAR-10 loading (host side, NumPy) with a deterministic synthetic fallback.

A copy of the reference package's ``data/cifar10.py`` loader, kept NumPy-only
so the port never imports the JAX package:

  * if the standard python-pickle batches (``cifar-10-batches-py``) exist
    under ``data_dir`` they are loaded, NHWC uint8;
  * otherwise a deterministic, learnable synthetic stand-in with the same
    shapes, dtypes and cardinalities (50k train / 10k test, 32x32x3 uint8,
    10 classes) is generated.  It is byte-identical to the reference's
    (tests/test_torch_port_data.py).

Channel normalization statistics are the reference training script's
(mean=[125.3,123.0,113.9]/255, std=[63.0,62.1,66.7]/255).
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import NamedTuple, Tuple

import numpy as np

MEAN = np.array([125.3, 123.0, 113.9], np.float32) / 255.0
STD = np.array([63.0, 62.1, 66.7], np.float32) / 255.0

TRAIN_SIZE = 50_000
TEST_SIZE = 10_000
NUM_CLASSES = 10


class Split(NamedTuple):
    images: np.ndarray  # [N,32,32,3] uint8
    labels: np.ndarray  # [N] int32


def _load_pickle_batches(batch_dir: str, names) -> Split:
    imgs, labs = [], []
    for name in names:
        with open(os.path.join(batch_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        imgs.append(np.ascontiguousarray(data, np.uint8))
        labs.append(np.asarray(d[b"labels"], np.int32))
    return Split(np.concatenate(imgs), np.concatenate(labs))


# Synthetic-task difficulty knobs: the reference's calibrated values, under
# which VGG-11 at lr 0.1 learns gradually instead of collapsing at ln(10)
# loss or saturating within one epoch.  Changing any of them breaks the
# byte-identity with the reference split.
_TEMPLATES_PER_CLASS = 3   # intra-class variety
_NOISE = 0.7               # per-pixel uniform noise fraction of the mix
_SHARED = 0.55             # inter-class template correlation
_CONTRAST = 0.5            # post-mix contrast toward mid-gray
_LABEL_NOISE = 0.1         # fraction of labels resampled uniformly


def _class_templates() -> np.ndarray:
    """Fixed low-frequency templates shared by both splits.

    [NUM_CLASSES, _TEMPLATES_PER_CLASS, 32, 32, 3]: each template blends one
    global base pattern, a per-class pattern and a per-template variant."""
    rng = np.random.default_rng(42)
    base = rng.uniform(40, 215, size=(1, 1, 4, 4, 3)).astype(np.float32)
    cls = rng.uniform(40, 215,
                      size=(NUM_CLASSES, 1, 4, 4, 3)).astype(np.float32)
    var = rng.uniform(40, 215,
                      size=(NUM_CLASSES, _TEMPLATES_PER_CLASS, 4, 4, 3)
                      ).astype(np.float32)
    small = _SHARED * base + (1 - _SHARED) * (0.65 * cls + 0.35 * var)
    return np.repeat(np.repeat(small, 8, axis=2), 8, axis=3)


@functools.lru_cache(maxsize=8)
def _synthetic_split(n: int, seed: int) -> Split:
    """Class-templated noisy images: deterministic, learnable, not trivial.

    A sample draws one of its class's templates, mixes in ``_NOISE`` uniform
    noise, is pulled toward mid-gray by ``_CONTRAST``, and with probability
    ``_LABEL_NOISE`` carries a uniformly resampled label.

    Memoized (the full 50k split costs seconds of NumPy); the cached arrays
    are shared by every caller and therefore read-only."""
    rng = np.random.default_rng(seed)
    templates = _class_templates()
    labels = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
    tidx = rng.integers(0, _TEMPLATES_PER_CLASS, size=n)
    noise = rng.uniform(0, 255, size=(n, 32, 32, 3)).astype(np.float32)
    images = (1 - _NOISE) * templates[labels, tidx] + _NOISE * noise
    images = 127.5 + _CONTRAST * (images - 127.5)
    if _LABEL_NOISE:
        flip = rng.random(n) < _LABEL_NOISE
        labels = np.where(flip, rng.integers(0, NUM_CLASSES, size=n),
                          labels).astype(np.int32)
    images = np.clip(images, 0, 255).astype(np.uint8)
    images.setflags(write=False)
    labels.setflags(write=False)
    return Split(images, labels)


def has_real_data(data_dir: str = "./data") -> bool:
    """Would ``load`` find the real python-pickle batches here?  The one
    check that ``load`` and ``--require-real-data`` (cli.py) share, so the
    flag can never disagree with what ``load`` does."""
    return os.path.isdir(os.path.join(data_dir, "cifar-10-batches-py"))


def load(data_dir: str = "./data") -> Tuple[Split, Split, bool]:
    """Return (train, test, is_real)."""
    if has_real_data(data_dir):
        batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
        train = _load_pickle_batches(
            batch_dir, [f"data_batch_{i}" for i in range(1, 6)])
        test = _load_pickle_batches(batch_dir, ["test_batch"])
        return train, test, True
    return (_synthetic_split(TRAIN_SIZE, seed=0),
            _synthetic_split(TEST_SIZE, seed=1), False)
