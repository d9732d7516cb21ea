"""Deterministic fault injection: the seeded chaos plan.

A copy of the reference package's ``ft/chaos.py``, with the same sites,
spec grammar and ``rng`` draws, so that one spec means the same faults in
both packages.  The port's ``Trainer`` fires ``nonfinite_grad`` and
``preempt``; it refuses a plan that names any other site
(``ft.check_sites``), since the layers those sites exercise are not
ported yet.

A chaos plan is a list of ``(site, step, seed)`` entries — parsed from CLI
specs ``SITE:step[:seed]`` or built programmatically — that fire EXACTLY
ONCE when training reaches the named step.  Determinism is the point: a
chaos run is reproducible (same plan, same seed, same faults at the same
steps), so the recovery path's output can be pinned against a fault-free
run in CI, which is what turns "we have retry code" into "the retry code
provably preserves the training stream".

Injection sites (each names a real failure mode of the training stack):

* ``producer_crash``   — the host-augment staging producer thread dies
                         (uncaught exception) while filling batch ``step``;
* ``put_delay``        — the chunk ``device_put`` covering ``step`` stalls
                         (sleeps past the watchdog timeout) once;
* ``put_fail``         — that put raises once (transient transfer error);
* ``corrupt_slot``     — the staged arena bytes for batch ``step`` are
                         corrupted (seeded XOR) after checksumming — the
                         signature of a buffer-reuse/aliasing bug;
* ``nonfinite_grad``   — the compiled step's gradients go NaN at batch
                         ``step`` (overflow/instability stand-in);
* ``preempt``          — SIGTERM is delivered to this process at the first
                         step boundary >= ``step`` (pod preemption).

Rank-level sites (elastic/ — round 6's world-resize layer).  For these the
third spec field is the RANK the fault is attributed to, not a payload
seed (``rank_death:step:rank``):

* ``rank_death``       — rank ``rank``'s device fails at the first step
                         boundary >= ``step``; the trainer raises
                         ``RankDeathError`` and the elastic coordinator
                         walks its degradation ladder (retry -> shrink ->
                         single-rank fallback);
* ``slow_rank``        — rank ``rank`` straggles: a configurable stall
                         (``FTConfig.slow_rank_stall_s``) is injected at
                         the step boundary and attributed to that rank's
                         step-time gauge, which the straggler detector
                         must flag;
* ``coordinator_loss`` — the elastic coordinator's in-memory membership
                         state is dropped once recovery progress reaches
                         ``step``; it must re-derive membership from the
                         checkpoint metadata alone.

Replica-level sites (serve/ — round 9's replicated serving tier).  The
third spec field is the target REPLICA index and ``step`` counts that
replica's OWN dispatches (``replica_death:dispatch:replica``):

* ``replica_death``    — the replica's scheduler worker raises
                         ``ChaosError`` at its dispatch ``step``; the
                         router must fail over every unfinished request
                         (in-flight and queued) to survivors — no
                         accepted request is silently dropped;
* ``slow_replica``     — the replica stalls ``slow_stall_s`` before its
                         dispatch ``step`` (a straggling chip); the
                         least-loaded router routes around it as its
                         measured service EWMA inflates;
* ``dispatch_fault``   — dispatch ``step``'s device result is discarded
                         at its COMPLETION fence
                         (``dispatch_fault:dispatch:replica``) — with the
                         pipelined scheduler, while dispatch ``step+1``
                         is already in flight.  The pin: the faulted
                         batch's requests resolve as explicit errors, the
                         in-flight successor resolves normally on the
                         same weights, and recovery is bitwise-identical
                         to the serial path — a completion fault is
                         isolated, never a silent drop and never a
                         replica death;
* ``swap_mid_batch``   — the replica's weight-watcher probe is invoked
                         INSIDE the dispatch hook of dispatch ``step``
                         (``swap_mid_batch:dispatch:replica``): a
                         pending publish races the dispatch already
                         being assembled.  The pin: the racing dispatch
                         is answered bitwise by the OLD weights (the
                         install lands at the next engine-free instant),
                         the next dispatch by the new — never a mix.

Publish-level sites (publish/ — round 10's train-to-serve hot-swap).
``step`` counts the publisher's OWN publishes (0-based) and the third
spec field is a payload seed (``publish_torn:publish[:seed]``):

* ``publish_torn``     — the published bundle's payload bytes are
                         corrupted (seeded XOR) AFTER the atomic rename,
                         so the file is well-formed but fails its
                         per-leaf crc32 — the watcher must reject it and
                         keep serving the old version;
* ``publish_stale``    — the publish re-announces the PREVIOUS version
                         (a duplicate/late publisher): the watcher must
                         skip it without staging or swapping anything.

The disabled plan is ``NULL_CHAOS`` — a stateless singleton exactly like
the telemetry ``NULL`` recorder: ``enabled`` is False, ``fire*`` return
False without allocating, and hot call sites guard on ``.enabled`` so the
no-chaos path costs nothing (pinned by tests/test_ft.py).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

SITES = ("producer_crash", "put_delay", "put_fail", "corrupt_slot",
         "nonfinite_grad", "preempt", "rank_death", "slow_rank",
         "coordinator_loss", "replica_death", "slow_replica",
         "publish_torn", "swap_mid_batch", "publish_stale",
         "dispatch_fault")
# Sites whose third spec field names the target RANK (elastic/), not a
# payload seed — same wire format, different interpretation.
RANK_SITES = ("rank_death", "slow_rank")
# Sites whose third spec field names the target serving REPLICA and whose
# step counts that replica's own dispatches (serve/replica.py).
REPLICA_SITES = ("replica_death", "slow_replica", "swap_mid_batch",
                 "dispatch_fault")
# Sites fired by the weight publisher (publish/publisher.py): step counts
# the publisher's own publishes, the third field is a payload seed.
PUBLISH_SITES = ("publish_torn", "publish_stale")


class ChaosError(RuntimeError):
    """An injected fault (never raised by real failures — recovery paths
    that catch broadly still distinguish injected faults in telemetry)."""


class RankDeathError(RuntimeError):
    """Rank ``rank``'s device failed at a step boundary.  Raised by the
    trainer's boundary poll (injected by the ``rank_death`` chaos site, or
    by a real device-probe failure); the trainer converts it into an
    emergency mid-epoch checkpoint and the elastic coordinator
    (elastic/coordinator.py) walks its degradation ladder.  Lives here —
    not in elastic/ — because the trainer must catch it without importing
    the elastic layer (which imports the trainer's step machinery)."""

    def __init__(self, rank: int, epoch: int, step: int):
        super().__init__(f"rank {rank} died at epoch {epoch} step {step}")
        self.rank = rank
        self.epoch = epoch
        self.step = step


class NullChaos:
    """The disabled plan: every query is False, no state can ever attach."""
    __slots__ = ()
    enabled = False

    def fire(self, site: str, step: int) -> bool:
        return False

    def fire_range(self, site: str, lo: int, hi: int) -> bool:
        return False

    def fire_reached(self, site: str, step: int) -> bool:
        return False

    def steps(self, site: str) -> Tuple[int, ...]:
        return ()

    def seed_of(self, site: str, step: int) -> int:
        return 0

    def spec(self):
        return []


NULL_CHAOS = NullChaos()


class ChaosPlan:
    """A list of one-shot injections, thread-safe (the staging producer
    thread fires sites too).  ``fired`` records what actually fired, in
    order — the test/telemetry surface."""

    enabled = True

    def __init__(self, entries: Sequence[Tuple[str, int, int]]):
        for site, step, _seed in entries:
            if site not in SITES:
                raise ValueError(f"unknown chaos site {site!r}; "
                                 f"expected one of {SITES}")
            if step < 0:
                raise ValueError(f"chaos step must be >= 0, got {step}")
        self._entries: List[dict] = [
            {"site": s, "step": st, "seed": sd, "fired": False}
            for s, st, sd in entries]
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int]] = []

    @classmethod
    def parse(cls, specs: Optional[Sequence[str]]):
        """Parse CLI specs ``SITE:step[:seed]`` -> plan (or ``NULL_CHAOS``
        for an empty list, so the disabled path stays the stateless
        singleton)."""
        if not specs:
            return NULL_CHAOS
        entries = []
        for spec in specs:
            parts = spec.split(":")
            if len(parts) not in (2, 3):
                raise ValueError(
                    f"bad chaos spec {spec!r}: expected SITE:step[:seed]")
            site = parts[0]
            try:
                step = int(parts[1])
                seed = int(parts[2]) if len(parts) == 3 else 0
            except ValueError:
                raise ValueError(f"bad chaos spec {spec!r}: step/seed must "
                                 f"be integers") from None
            entries.append((site, step, seed))
        return cls(entries)

    def _fire(self, site: str, match) -> Optional[dict]:
        with self._lock:
            for e in self._entries:
                if e["site"] == site and not e["fired"] and match(e["step"]):
                    e["fired"] = True
                    self.fired.append((site, e["step"]))
                    return e
        return None

    def fire(self, site: str, step: int) -> bool:
        """One-shot: True exactly once per entry whose step == ``step``."""
        return self._fire(site, lambda s: s == step) is not None

    def fire_range(self, site: str, lo: int, hi: int) -> bool:
        """One-shot over a half-open step range [lo, hi) — chunk-level
        sites cover several batches per operation."""
        return self._fire(site, lambda s: lo <= s < hi) is not None

    def fire_reached(self, site: str, step: int) -> bool:
        """One-shot when progress ``step`` reaches/passes the entry —
        boundary-polled sites (preemption is checked between dispatch
        windows, not at every batch)."""
        return self._fire(site, lambda s: step >= s) is not None

    def steps(self, site: str) -> Tuple[int, ...]:
        """All step indices planned for ``site`` (fired or not) — what the
        compiled-in injection closures are built from."""
        return tuple(e["step"] for e in self._entries if e["site"] == site)

    def seed_of(self, site: str, step: int) -> int:
        """The third spec field of the entry planned at (site, step) — a
        payload seed for data-level sites, the target RANK for the
        rank-level sites (RANK_SITES).  0 when no such entry exists."""
        for e in self._entries:
            if e["site"] == site and e["step"] == step:
                return e["seed"]
        return 0

    def spec(self):
        """Manifest-shaped view of the plan (site/step/seed per entry)."""
        return [{"site": e["site"], "step": e["step"], "seed": e["seed"]}
                for e in self._entries]

    def rng(self, site: str, step: int):
        """Seeded generator for an entry's fault payload (corruption byte
        positions/values) — deterministic in (seed, site, step)."""
        import numpy as np
        seed = 0
        for e in self._entries:
            if e["site"] == site and e["step"] == step:
                seed = e["seed"]
                break
        return np.random.default_rng([seed, SITES.index(site), step])
