"""Dataset sharding — the DistributedSampler equivalent (NumPy).

A copy of the reference package's ``data/sharding.py``.  Two quirks of the
reference training script are kept:

  * the shard permutation is identical every epoch (the script never calls
    ``set_epoch``); ``reshuffle_each_epoch=True`` opts out;
  * like torch's DistributedSampler, the index list is wrap-padded to a
    multiple of the world size and dealt round-robin: rank r takes
    ``perm[r::world]``.

``rank_data_keys`` is the reference's ``elastic/protocol.py`` function of
that name, which checkpoints record and a resume re-derives.
"""

from __future__ import annotations

import zlib
from typing import Tuple

import numpy as np

# How many leading indices of each rank's stream a data-order key digests.
_KEY_PREFIX = 64


def _wrap_pad(perm: np.ndarray, total: int) -> np.ndarray:
    """Pad ``perm`` to ``total`` by wrapping, as torch's DistributedSampler
    does — tiling the whole list when the padding exceeds the dataset."""
    if total <= perm.shape[0]:
        return perm[:total]
    reps = -(-total // perm.shape[0])  # ceil
    return np.concatenate([perm] * reps)[:total]


def canonical_epoch_order(n: int, *, seed: int = 0, shuffle: bool = True,
                          epoch: int = 0, reshuffle_each_epoch: bool = False,
                          pad_to: int | None = None) -> np.ndarray:
    """The world-invariant example order for ``epoch``: rank r of world w
    takes positions ``r::w`` of it (after wrap-padding)."""
    if shuffle:
        s = seed + (epoch if reshuffle_each_epoch else 0)
        perm = np.random.default_rng(s).permutation(n)
    else:
        perm = np.arange(n)
    if pad_to is not None:
        perm = _wrap_pad(perm, pad_to)
    return perm


class ShardedSampler:
    """Per-rank epoch index streams over a dataset of ``n`` examples."""

    def __init__(self, n: int, world: int, rank: int, *, seed: int = 0,
                 shuffle: bool = True, reshuffle_each_epoch: bool = False):
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} out of range for world {world}")
        self.n = n
        self.world = world
        self.rank = rank
        self.seed = seed
        self.shuffle = shuffle
        self.reshuffle_each_epoch = reshuffle_each_epoch
        self.num_samples = -(-n // world)  # ceil
        self.total = self.num_samples * world

    def epoch_indices(self, epoch: int = 0) -> np.ndarray:
        """Indices this rank processes in ``epoch`` (len == num_samples)."""
        perm = canonical_epoch_order(
            self.n, seed=self.seed, shuffle=self.shuffle, epoch=epoch,
            reshuffle_each_epoch=self.reshuffle_each_epoch,
            pad_to=self.total)
        return perm[self.rank:: self.world]


def global_epoch_indices(n: int, world: int, *, seed: int = 0,
                         shuffle: bool = True, epoch: int = 0,
                         reshuffle_each_epoch: bool = False) -> np.ndarray:
    """[world, num_samples] index matrix: row r is rank r's stream, column b
    is global batch b's composition."""
    samplers = [ShardedSampler(n, world, r, seed=seed, shuffle=shuffle,
                               reshuffle_each_epoch=reshuffle_each_epoch)
                for r in range(world)]
    return np.stack([s.epoch_indices(epoch) for s in samplers])


def rank_data_keys(n: int, world: int, *, seed: int = 0, epoch: int = 0,
                   shuffle: bool = True,
                   reshuffle_each_epoch: bool = False) -> Tuple[int, ...]:
    """Per-rank data-order keys: a crc32 digest of the first
    ``_KEY_PREFIX`` indices each rank deals in ``epoch``.  Written into
    checkpoint metadata at save time and re-derived at resume time: a
    mismatch means the dataset or seed changed under the checkpoint."""
    num = -(-n // world) * world
    order = canonical_epoch_order(
        n, seed=seed, shuffle=shuffle, epoch=epoch,
        reshuffle_each_epoch=reshuffle_each_epoch, pad_to=num)
    return tuple(
        int(zlib.crc32(np.ascontiguousarray(
            order[r::world][:_KEY_PREFIX], dtype=np.int64).tobytes()))
        for r in range(world))
