"""Token sequences made from the run's seed, in the files a token model's
``Trainer`` reads from its ``data_dir`` (``tokens/train.npy`` and
``tokens/test.npy``: int32 [N, seq_len + 1]), and the reference's batches
of them.

Ids are drawn over the ``vocab`` ids of the vocabulary slice by a Zipf
rank-frequency law, P(rank r) proportional to r^-zipf_s (natural text's s
of about 1), the ranks mapped to ids by a permutation drawn from the same
seed, so the frequent ids are spread over the slice.  The draws come from
a ``torch.Generator`` seeded with ``seed`` on the device that makes the
split (the training split; the test split ``seed + 1``).

An example is a sequence of ``seq_len + 1`` ids: its first ``seq_len`` the
input, its last ``seq_len`` the targets, one a position.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

DIR = "tokens"
FILES = ("train.npy", "test.npy")


def sequences(n: int, dataset: dict, seed: int, device="cpu") -> np.ndarray:
    """int32 [n, seq_len + 1] drawn from ``seed`` on ``device``."""
    vocab, s = dataset["vocab"], dataset["seq_len"]
    gen = torch.Generator(device).manual_seed(seed)
    rank_to_id = torch.randperm(vocab, generator=gen, device=device)
    ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    p = ranks.pow(-float(dataset["zipf_s"]))
    draws = torch.multinomial((p / p.sum()).float(), n * (s + 1),
                              replacement=True, generator=gen)
    return rank_to_id[draws].reshape(n, s + 1).to(torch.int32).cpu().numpy()


def make(dataset: dict, seed: int, data_dir: str, device) -> None:
    os.makedirs(os.path.join(data_dir, DIR), exist_ok=True)
    for name, n, s in ((FILES[0], dataset["train_sequences"], seed),
                       (FILES[1], dataset["test_sequences"], seed + 1)):
        np.save(os.path.join(data_dir, DIR, name),
                sequences(n, dataset, s, device))


def examples(dataset: dict) -> int:
    return dataset["train_sequences"]


def read(data_dir: str) -> np.ndarray:
    return np.load(os.path.join(data_dir, DIR, FILES[0]))


def batch(split: np.ndarray, rows: np.ndarray, traffic: dict, seed: int,
          rank: int, step: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    if traffic["augment"]:
        raise ValueError("tokens_zipf's sequences take no augmentation: the "
                         "traffic must set augment false")
    seqs = torch.from_numpy(split[rows].astype(np.int64)).to(device)
    return seqs[:, :-1], seqs[:, 1:]
