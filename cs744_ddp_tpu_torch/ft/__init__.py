"""Fault tolerance: the chaos plan, the non-finite step guard and
preemption-safe mid-epoch resume (the reference package's ``ft/``).

Everything is opt-in through one ``FTConfig`` handed to ``Trainer``; the
default (``ft=None``) leaves every hot path as it is without it: the chaos
plan is the stateless ``NULL_CHAOS`` and the guard is not built into the
step.

The reference's staging supervision (``ft/supervisor.py``, the
``producer_crash``, ``put_delay``, ``put_fail`` and ``corrupt_slot``
sites, the ``put_*`` / ``stall_timeout_s`` / ``verify_chunks`` fields)
needs the host loader, and its rank, replica and publish sites need the
elastic, serving and publishing layers; none is ported yet, and the
Trainer refuses a plan that names their sites (``check_sites``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

from .chaos import (NULL_CHAOS, PUBLISH_SITES, RANK_SITES, REPLICA_SITES,
                    ChaosError, ChaosPlan, NullChaos, RankDeathError, SITES)
from .guard import POLICIES, NonFiniteError
from .preempt import PreemptedError, PreemptionGuard

# The sites the port's Trainer fires.
FIRED_SITES = ("nonfinite_grad", "preempt")
# Every other site, by the ROADMAP queue 1 item that brings its layer.
_LATER = {
    **dict.fromkeys(("producer_crash", "put_delay", "put_fail",
                     "corrupt_slot"), "queue 1 item 2 (the host loader)"),
    **dict.fromkeys(RANK_SITES + ("coordinator_loss",),
                    "queue 1 item 3 (elastic)"),
    **dict.fromkeys(REPLICA_SITES + PUBLISH_SITES,
                    "queue 1 item 5 (serving and publishing)"),
}


class FTConfig(NamedTuple):
    """Fault-tolerance knobs, with the reference's field names and
    defaults.

    nonfinite : "off" | "halt" | "skip" | "restore" step-guard policy.
    chaos     : ChaosPlan (or NULL_CHAOS) of deterministic injections.
    """

    nonfinite: str = "off"
    chaos: Any = NULL_CHAOS


def check_sites(chaos) -> None:
    """Refuse a plan that names a site the port cannot fire yet: it would
    be accepted and then never fire."""
    for entry in chaos.spec():
        site = entry["site"]
        if site not in FIRED_SITES:
            raise ValueError(
                f"chaos site {site!r} is not ported yet: it comes with "
                f"ROADMAP {_LATER[site]}; the port fires {FIRED_SITES}")


__all__ = [
    "FTConfig", "ChaosPlan", "ChaosError", "NullChaos", "NULL_CHAOS", "SITES",
    "PUBLISH_SITES", "RANK_SITES", "REPLICA_SITES", "RankDeathError",
    "FIRED_SITES", "check_sites", "POLICIES", "NonFiniteError",
    "PreemptedError", "PreemptionGuard",
]
