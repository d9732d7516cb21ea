"""Fault tolerance: the chaos plan, the non-finite step guard,
preemption-safe mid-epoch resume and the supervision of the host-augment
staging pipeline (the reference package's ``ft/``).

Everything is opt-in through one ``FTConfig`` handed to ``Trainer``; the
default (``ft=None``) leaves every hot path as it is without it: the chaos
plan is the stateless ``NULL_CHAOS``, the guard is not built into the
step and the staging puts run unsupervised.

The staging sites (``producer_crash``, ``put_delay``, ``put_fail``,
``corrupt_slot``) and the ``put_*`` / ``stall_timeout_s`` /
``producer_restarts`` / ``verify_chunks`` / ``degrade_staging`` fields act
on the chunked host-augment pipeline (``train/loop.py``,
``ft/supervisor.py``), so a plan that names a staging site is refused on a
Trainer without ``host_augment``, where the reference would never fire it.
The rank sites (``rank_death``, ``slow_rank``) fire at the Trainer's
window boundaries (``Trainer._rank_boundary``) and ``coordinator_loss`` in
the elastic coordinator (``elastic/coordinator.py``), so it is accepted
only under ``elastic``.  The publish sites (``publish_torn``,
``publish_stale``) fire in the weight publisher of a run with a publish
directory (``Trainer.run(publish_dir=)``, ``--publish-dir``), and are
refused without one.  The replica sites ``replica_death``,
``slow_replica``, ``dispatch_fault`` and ``swap_mid_batch`` fire in the
serving tier's replicas (``serve/replica.py``, the CLI's
``--serve-frontend``), and only there: the Trainer refuses them;
``swap_mid_batch`` also needs a weight watcher (``--serve-publish-dir``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

from .chaos import (NULL_CHAOS, PUBLISH_SITES, RANK_SITES, REPLICA_SITES,
                    ChaosError, ChaosPlan, NullChaos, RankDeathError, SITES)
from .guard import POLICIES, NonFiniteError
from .preempt import PreemptedError, PreemptionGuard
from .supervisor import (StagingStalled, Watchdog, batch_checksums,
                         call_with_retry, verify_checksums)

# The sites that fire on the host-augment staging pipeline only.
STAGING_SITES = ("producer_crash", "put_delay", "put_fail", "corrupt_slot")
# The sites a training run fires: the port's Trainer, the elastic
# coordinator (coordinator_loss) and the weight publisher (the publish
# sites).
FIRED_SITES = STAGING_SITES + ("nonfinite_grad", "preempt") + RANK_SITES \
    + ("coordinator_loss",) + PUBLISH_SITES
# The sites the serving tier's replicas fire (--serve-frontend).
SERVE_SITES = REPLICA_SITES


class FTConfig(NamedTuple):
    """Fault-tolerance knobs, with the reference's field names and
    defaults (production-shaped; tests shrink the timeouts).

    nonfinite         : "off" | "halt" | "skip" | "restore" step-guard policy.
    chaos             : ChaosPlan (or NULL_CHAOS) of deterministic injections.
    put_timeout_s     : watchdog deadline for one chunk's host-to-device copy
                        (and the arena fence wait); overruns are logged, not
                        interrupted.
    put_retries       : total attempts for a failing chunk put.
    backoff_base_s    : exponential backoff base between put retries.
    stall_timeout_s   : consumer-side deadline with no staged item arriving
                        while the producer looks alive -> treated as a
                        producer failure (restart once, then degrade).
    producer_restarts : producer restart attempts before degrading to the
                        synchronous per-batch staging path.
    verify_chunks     : crc32-verify staged rows right before each put
                        (on by itself when the chaos plan corrupts slots).
    degrade_staging   : start in the degraded synchronous staging mode
                        (measures the fallback).
    slow_rank_stall_s : stall injected per ``slow_rank`` chaos entry and
                        added to the target rank's step-time gauge (the
                        straggler detector must flag it).
    """

    nonfinite: str = "off"
    chaos: Any = NULL_CHAOS
    put_timeout_s: float = 30.0
    put_retries: int = 3
    backoff_base_s: float = 0.05
    stall_timeout_s: float = 120.0
    producer_restarts: int = 1
    verify_chunks: bool = False
    degrade_staging: bool = False
    slow_rank_stall_s: float = 0.25


def check_sites(chaos, host_augment: bool = False,
                elastic: bool = False, serving: bool = False,
                publish: bool = False) -> None:
    """Refuse a plan that names a site the run would not fire: a replica
    site in training or a training site in serving (``serving``: the
    serving tier's replicas), a staging site without ``host_augment``,
    ``coordinator_loss`` without ``elastic`` (no coordinator runs), a
    publish site in training without ``publish`` (no publisher runs:
    ``--publish-dir``), or ``swap_mid_batch`` in serving without
    ``publish`` (no watcher to probe: ``--serve-publish-dir``).  Each
    would be accepted and then never fire."""
    for entry in chaos.spec():
        site = entry["site"]
        if serving:
            if site not in SERVE_SITES:
                raise ValueError(
                    f"chaos site {site!r} fires in training only; the "
                    f"serving tier (--serve-frontend) fires {SERVE_SITES}")
            if site == "swap_mid_batch" and not publish:
                raise ValueError(
                    "chaos site 'swap_mid_batch' probes the weight "
                    "watcher inside a dispatch: it needs "
                    "--serve-publish-dir")
            continue
        if site in SERVE_SITES:
            raise ValueError(
                f"chaos site {site!r} fires in the serving tier's replicas "
                f"only (--serve-frontend): no replica runs in training")
        if site in STAGING_SITES and not host_augment:
            raise ValueError(
                f"chaos site {site!r} fires on the host-augment staging "
                f"pipeline only: it needs host_augment (--host-augment)")
        if site == "coordinator_loss" and not elastic:
            raise ValueError(
                "chaos site 'coordinator_loss' fires in the elastic "
                "coordinator only: it needs elastic (--elastic weak|strong)")
        if site in PUBLISH_SITES and not publish:
            raise ValueError(
                f"chaos site {site!r} fires in the weight publisher only: "
                f"it needs publish_dir (--publish-dir)")


__all__ = [
    "FTConfig", "ChaosPlan", "ChaosError", "NullChaos", "NULL_CHAOS", "SITES",
    "PUBLISH_SITES", "RANK_SITES", "REPLICA_SITES", "RankDeathError",
    "FIRED_SITES", "SERVE_SITES", "STAGING_SITES", "check_sites",
    "POLICIES",
    "NonFiniteError", "PreemptedError", "PreemptionGuard", "StagingStalled",
    "Watchdog", "call_with_retry", "batch_checksums", "verify_checksums",
]
