"""Collective accounting over a step's link record: the counterpart of the
reference package's ``analysis/stats.py`` (``collective_stats``,
``collective_chain_depth``, ``bytes_of_type``), computed over the
``Collective`` records a ``parallel.mesh.Group`` keeps for one step
(``step_links``; a ``CountingGroup`` keeps the same for a counted step on
meta tensors) instead of over an HLO module.

- Counts and bytes are the strategy's collectives (``counted``), under the
  reference's op names (``Group.OP_NAMES``), bytes as ``Group`` counts
  them: the result of each collective.
- ``collective_chain_depth`` is the number of LINKS: in eager execution a
  collective runs only after the one before it, so the links form one
  chain, and a blocking collective is a link of its own while the
  asynchronous ones issued before a ``wait()`` share one
  (``OverlappedDDP``, ``BackwardOverlap``).  Where the reference reads a
  data-dependency chain in the pre-optimization HLO, the port's depth is
  defined by waits.  By default it counts the strategy's collectives; the
  blocking mean of the BN statistics and the loss that follows them
  (``train/step.py::mean_over_ranks``, uncounted) is one link more
  (``counted_only=False``), which the reference's HLO has in parallel
  with the gradient chain.

No counterpart: the reference's HLO parser (``analysis/hlo_ir.py``) and
``utils/hlo_stats.py``, its regex adapter, since nothing the port runs
produces HLO text; nor ``collective_dot_cones``, whose overlap signature
the audit reads from the issue positions of the buckets instead
(``analysis/audit.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence

import torch

from ..parallel.mesh import Collective, Group


def bytes_of_type(dtype: torch.dtype, shape: Sequence[int]) -> int:
    """Bytes of a tensor of ``dtype`` and ``shape``."""
    return math.prod(int(d) for d in shape) * \
        torch.empty((), dtype=dtype).element_size()


def _counted(links: Iterable[Collective], counted_only: bool):
    return [c for c in links if c.counted or not counted_only]


def collective_stats(links: Iterable[Collective],
                     counted_only: bool = True) -> Dict:
    """{"ops": {op: {"count", "result_mib"}}, "total_count",
    "total_result_mib"} over the step's collectives."""
    ops: Dict[str, Dict[str, float]] = {}
    for c in _counted(links, counted_only):
        entry = ops.setdefault(Group.OP_NAMES[c.kind],
                               {"count": 0, "result_mib": 0.0})
        entry["count"] += 1
        entry["result_mib"] += c.nbytes / 2**20
    for entry in ops.values():
        entry["result_mib"] = round(entry["result_mib"], 2)
    return {
        "ops": ops,
        "total_count": sum(e["count"] for e in ops.values()),
        "total_result_mib": round(
            sum(e["result_mib"] for e in ops.values()), 2),
    }


def collective_bytes(links: Iterable[Collective],
                     counted_only: bool = True) -> Dict[str, int]:
    """Exact result bytes per op name (``collective_stats`` rounds to
    MiB)."""
    out: Dict[str, int] = {}
    for c in _counted(links, counted_only):
        op = Group.OP_NAMES[c.kind]
        out[op] = out.get(op, 0) + c.nbytes
    return out


def collective_chain_depth(links: Iterable[Collective],
                           counted_only: bool = True) -> int:
    """The step's collectives that run one after another: its distinct
    links (module docstring)."""
    return len({c.link for c in _counted(links, counted_only)})
