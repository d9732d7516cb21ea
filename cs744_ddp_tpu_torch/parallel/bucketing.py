"""Gradient bucketing: group the parameter-gradient leaves into
size-bounded buckets, one collective each — torch DDP's reducer bucketing
(``DDP(model)``, reference Part 3/main.py:61), as the reference package's
``parallel/bucketing.py`` plans it.

Leaves are a list in the model's registration order (torch DDP plans over
the same order), bucketed in REVERSE, since backward produces the last
layer's gradients first.  Each bucket is all-reduced as one flat buffer
(strategies.bucketed_psum).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

DEFAULT_BUCKET_BYTES = 25 * 2 ** 20  # torch DDP default bucket_cap_mb=25


class BucketPlan(NamedTuple):
    buckets: Tuple[Tuple[int, ...], ...]    # each bucket: leaf indices

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)


class BucketSchedule(NamedTuple):
    """``order``: bucket indices in the order backward completes them (plan
    order, as buckets are built last leaf first); ``gate_leaf``: per
    bucket, the member with the lowest registration index, whose gradient
    is normally the bucket's last to arrive."""
    order: Tuple[int, ...]
    gate_leaf: Tuple[int, ...]


def make_schedule(plan: BucketPlan) -> BucketSchedule:
    return BucketSchedule(order=tuple(range(len(plan.buckets))),
                          gate_leaf=tuple(min(b) for b in plan.buckets))


def leaf_bytes(leaf) -> int:
    """Bytes of a tensor or array (anything with ``shape`` and a
    ``dtype.itemsize``)."""
    return math.prod(leaf.shape) * leaf.dtype.itemsize


def make_plan(params_like: Sequence,
              bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> BucketPlan:
    nbytes = [leaf_bytes(l) for l in params_like]
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in reversed(range(len(nbytes))):  # DDP: reverse registration order
        if cur and cur_bytes + nbytes[i] > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes[i]
    if cur:
        buckets.append(cur)
    return BucketPlan(buckets=tuple(tuple(b) for b in buckets))
