"""Elastic coordinator: cluster membership and the degradation ladder (the
reference package's ``elastic/coordinator.py``).

The coordinator owns what the ranks cannot: the decision of WHAT WORLD
SIZE to run at.  The reference builds each world's trainer in its own
process; the port runs one process per rank, so each membership
generation is a fresh launch of ``world`` ranks, one device per member
(``launch``, a callable: the CLI's spawns processes on a fresh rendezvous
port; tests pass stand-ins).  A generation whose ranks report a death
(``Generation.rank_death``; they wrote the emergency mid-epoch checkpoint
before exiting) sends the coordinator down the ladder:

  1. **retry**  — if the reported rank's device probes healthy and
     ``trust_probe`` is set, the fault is taken as transient and the SAME
     world is relaunched (at most ``max_retries`` times).  Off by default:
     a chaos-injected death must be taken at face value.
  2. **shrink** — relaunch at the LARGEST feasible world <= M-1
     (``protocol.plan_shrink``) on the surviving members; the new world
     resumes the emergency checkpoint.
  3. **single-rank fallback** — repeated deaths shrink to world 1
     (``degraded``).

The chaos plan is the coordinator's: each generation gets the entries
that have not fired (``ChaosPlan.pending``), and reports the ones that
fired in it, which the coordinator marks fired, so a one-shot fault fires
in exactly one generation.  The ``coordinator_loss`` site drops the
membership mid-recovery and it is re-derived from the checkpoint metadata
on disk: nothing the coordinator decides from lives only in a process
that is gone.  Membership changes under a lock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

from ..ft import NULL_CHAOS
from ..parallel import mesh as meshlib
from ..train import checkpoint as ckptlib
from .protocol import flat_meta, plan_shrink, world_of


class Generation(NamedTuple):
    """What one launch reports: ``rank_death`` (rank, epoch, step) or None
    when it ran to its end (or was preempted), and the chaos entries that
    fired in it as ``(site, step)``."""
    rank_death: Optional[Tuple[int, int, int]]
    fired: Tuple[Tuple[str, int], ...] = ()


# launch(world, members, epochs, checkpoint_dir, chaos specs) -> Generation
Launch = Callable[[int, Tuple[int, ...], int, str, List[str]], Generation]


class ElasticCoordinator:
    """Membership and the degradation ladder over a ``launch`` callable.
    ``probe(members) -> dead ranks`` checks the members' devices
    (``parallel.mesh.probe_devices``)."""

    def __init__(self, launch: Launch, *, world: int, global_batch: int,
                 protocol: str = "strong", microshards: Optional[int] = 4,
                 chaos=NULL_CHAOS, max_retries: int = 1,
                 trust_probe: bool = False,
                 probe: Callable[[Sequence[int]], List[int]] =
                 meshlib.probe_devices,
                 log: Callable[[str], None] = print):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self._launch = launch
        self._probe = probe
        self._lock = threading.Lock()
        self.log = log
        self.chaos = chaos
        self.global_batch = global_batch
        self.protocol = protocol
        self.microshards = microshards if protocol == "strong" else None
        self.max_retries = max_retries
        self.trust_probe = trust_probe
        self.retries_used = 0
        self.recoveries = 0
        self.events: List[dict] = []
        self.world = world
        self.members: Tuple[int, ...] = tuple(range(world))
        self.generation = 0
        self.degraded = world == 1

    # -- the run loop -------------------------------------------------------

    def run(self, epochs: int, checkpoint_dir: str) -> Generation:
        """Launch generations until one runs to its end; its report."""
        while True:
            t0 = time.time()
            gen = self._launch(self.world, self.members, epochs,
                               checkpoint_dir, self.chaos.pending()
                               if self.chaos.enabled else [])
            for site, step in gen.fired:
                self.chaos.fire(site, step)
            if gen.rank_death is None:
                return gen
            self._recover(gen.rank_death, checkpoint_dir,
                          run_time_s=time.time() - t0)

    # -- recovery -----------------------------------------------------------

    def _recover(self, death: Tuple[int, int, int], checkpoint_dir: str, *,
                 run_time_s: float) -> None:
        rank, epoch, step = death
        self.recoveries += 1
        t0 = time.time()
        if self.chaos.enabled and self.chaos.fire_reached(
                "coordinator_loss", self.recoveries - 1):
            with self._lock:
                self.members = ()
            self.log("chaos: coordinator membership state lost; "
                     "re-deriving from checkpoint metadata")
            self._rederive_membership(checkpoint_dir)
        with self._lock:
            members = self.members or tuple(range(self.world))
        dead_ranks = set(self._probe(members))
        if self.trust_probe and rank not in dead_ranks and \
                self.retries_used < self.max_retries:
            # Rung 1: the rank probes healthy — transient fault, retry at
            # the same world; the emergency checkpoint makes it a resume.
            self.retries_used += 1
            self.events.append({
                "kind": "retry", "rank": rank, "epoch": epoch,
                "step": step, "world": self.world,
                "recovery_s": time.time() - t0})
            self.log(f"elastic: rank {rank} probes healthy; retrying at "
                     f"world {self.world} "
                     f"({self.retries_used}/{self.max_retries})")
            return
        # Rung 2/3: the rank is gone — shrink to the largest feasible
        # world on the surviving members.
        dead_ranks.add(rank)
        if self.world <= 1:
            raise RuntimeError(
                f"rank {rank} died at world 1 — no smaller world to "
                f"degrade to (epoch {epoch} step {step})")
        new_world = plan_shrink(self.world, self.global_batch,
                                microshards=self.microshards)
        with self._lock:
            old_world = self.world
            # A rank is a position in the generation's members.
            dead = [members[r] for r in dead_ranks if r < len(members)]
            self.members = meshlib.surviving_members(members, new_world,
                                                     dead)
            self.world = new_world
            self.generation += 1
            self.degraded = new_world == 1
        self.events.append({
            "kind": "shrink", "rank": rank, "epoch": epoch, "step": step,
            "from_world": old_world, "to_world": new_world,
            "run_time_s": run_time_s, "recovery_s": time.time() - t0})
        self.log(f"elastic: rank {rank} died at epoch {epoch} step {step}; "
                 f"shrinking world {old_world} -> {new_world}"
                 + (" (single-rank fallback)" if new_world == 1 else ""))

    def _rederive_membership(self, checkpoint_dir: str) -> None:
        """Rebuild membership from checkpoint metadata alone (the
        ``coordinator_loss`` recovery): the ranks' emergency save lands
        before the coordinator recovers, so disk is the authoritative
        record of the world that was running."""
        meta = flat_meta(ckptlib.read_mid_epoch_meta(checkpoint_dir)
                         or ckptlib.read_epoch_meta(checkpoint_dir))
        if not meta:
            raise RuntimeError(
                "coordinator state lost and no checkpoint metadata on "
                "disk to re-derive membership from")
        w = world_of(meta)
        with self._lock:
            self.world = w
            self.members = tuple(range(w))

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        with self._lock:
            return {
                "world": self.world,
                "members": list(self.members),
                "generation": self.generation,
                "degraded": self.degraded,
                "protocol": self.protocol,
                "recoveries": self.recoveries,
                "retries_used": self.retries_used,
                "events": list(self.events),
            }
