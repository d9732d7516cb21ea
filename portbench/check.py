"""The comparison that decides ``correct``.

The program's first steps (``worker.checked_steps``: the same Trainer the
window then trains, driven through the window's own call) and the plain
reference's (``reference/steps.py``) give ``Readings``; the numbers
compared are:

  * ``loss_gap_<s>``: |loss - reference| / |reference| of step s;
  * ``grad_gap``: over the parameters, the worst gap between the norms of
    the first step's gradient as the optimizer got it (the program's from
    its momentum after one step: v - wd p0) and the reference's, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger;
  * ``change_gap``: the same of the parameters' change over the steps,
    over the leaves whose reference gradient is at least a thousandth of
    the median leaf's (the others, such as a convolution's bias before a
    BatchNorm, move by weight decay and round-off alone);
  * ``stats1_gap``: the same of the compared state's change after the
    first step: the state the architecture names (``CHECKED_STATE`` in
    ``arch/<architecture>.py``; the BN running statistics of the CIFAR
    classifiers: the forward alone, which a pool window's near-tie, routed
    to different elements by the program and the reference, does not
    reach); absent where it names none;
  * ``grad_gap_median``, ``change_gap_median``: the median leaf's gap of
    the first gradient and of the change.  The worst leaf is one
    of a few small ill-conditioned leaves (a convolution's bias before a
    BatchNorm, the first block's BN gamma and beta, whose gradient is a sum
    that nearly cancels): its reading swings from seed to seed, while the
    median leaf's is steady and moves with the precision of every leaf.

Each has a limit in the cell's file (``workloads/<cell>.json``,
``limits``); a limit of null marks a number that is read and printed but
not compared (PERF.md gives why).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from .reference.steps import Readings

# Leaves whose reference gradient is under this share of the median
# leaf's are left out of ``change_gap``.
DEAD_LEAF = 1e-3


def leaf_gaps(prog: Sequence[float], ref: Sequence[float]) -> List[float]:
    """Each leaf's |program - reference| over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    if len(prog) != len(ref) or not ref:
        raise ValueError(f"{len(prog)} program leaves against {len(ref)} "
                         f"reference leaves")
    med = statistics.median(ref)
    return [abs(p - r) / max(r, med) for p, r in zip(prog, ref)]


def numbers(prog: Readings, ref: Readings) -> Dict[str, float]:
    """Every number the comparison reads, by name."""
    if len(prog.losses) != len(ref.losses):
        raise ValueError("the two sides ran different numbers of steps")
    out = {f"loss_gap_{i + 1}": abs(p - r) / abs(r)
           for i, (p, r) in enumerate(zip(prog.losses, ref.losses))}
    grad = leaf_gaps(prog.grad1, ref.grad1)
    floor = DEAD_LEAF * statistics.median(ref.grad1)
    keep = [i for i, g in enumerate(ref.grad1) if g >= floor]
    change = leaf_gaps([prog.change[i] for i in keep],
                       [ref.change[i] for i in keep])
    out["grad_gap"] = max(grad)
    out["change_gap"] = max(change)
    if prog.stats_change1 or ref.stats_change1:
        out["stats1_gap"] = max(leaf_gaps(prog.stats_change1,
                                          ref.stats_change1))
    out["grad_gap_median"] = statistics.median(grad)
    out["change_gap_median"] = statistics.median(change)
    return out


def judge(values: Dict[str, float], limits: Dict[str, Optional[float]]
          ) -> Tuple[bool, List[Tuple[str, Optional[float], Optional[float]]]]:
    """(correct, [(name, value, limit)]).  A number with no limit key, a
    value that is not finite, or a limit whose number the run did not give
    (its value None) is not correct; a null limit is printed and not
    compared."""
    rows, ok = [], True
    for name, value in values.items():
        if name not in limits:
            ok = False
            rows.append((name, value, float("nan")))
            continue
        limit = limits[name]
        if limit is not None and not value <= limit:
            ok = False
        rows.append((name, value, limit))
    for name, limit in limits.items():
        if name not in values and limit is not None:
            ok = False
            rows.append((name, None, limit))
    return ok, rows
