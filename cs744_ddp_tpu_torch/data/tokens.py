"""Token sequences for a token model (``models.input_kind(name) ==
"tokens"``), host side, NumPy.

A split is ``tokens/train.npy`` and ``tokens/test.npy`` under the
Trainer's ``data_dir``: int32 ``[N, S + 1]`` each, one training sequence a
row.  Row n gives the model's input ``ids[n, :-1]`` and the targets
``ids[n, 1:]`` (the next token at every position), so a split here is a
``cifar10.Split`` whose ``images`` are the inputs [N, S] and ``labels`` the
targets [N, S]: the Trainer's staging, sampler and eval take either kind
alike.  There is no synthetic fallback: a token model's run writes its
split first (``write``).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .cifar10 import Split

DIR = "tokens"
TRAIN_FILE = "train.npy"
TEST_FILE = "test.npy"


def _path(data_dir: str, name: str) -> str:
    return os.path.join(data_dir, DIR, name)


def write(data_dir: str, train: np.ndarray, test: np.ndarray) -> None:
    """Write int32 [N, S + 1] sequences as the two files ``load`` reads."""
    os.makedirs(os.path.join(data_dir, DIR), exist_ok=True)
    for name, seqs in ((TRAIN_FILE, train), (TEST_FILE, test)):
        np.save(_path(data_dir, name), np.ascontiguousarray(seqs, np.int32))


def _split(seqs: np.ndarray) -> Split:
    if seqs.ndim != 2 or seqs.shape[1] < 2 or seqs.dtype != np.int32:
        raise ValueError(f"token sequences must be int32 [N, S + 1], got "
                         f"{seqs.dtype} {seqs.shape}")
    return Split(seqs[:, :-1], seqs[:, 1:])


def load(data_dir: str) -> Tuple[Split, Split]:
    """(train, test) from ``data_dir``; raises if the files are absent."""
    train, test = (_path(data_dir, n) for n in (TRAIN_FILE, TEST_FILE))
    for path in (train, test):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"a token model reads its split from "
                                    f"{path}, which is not there")
    return _split(np.load(train)), _split(np.load(test))
