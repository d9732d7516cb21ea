"""Process-group bootstrap and the counting layer of the strategies'
collectives.

The reference package's mesh (``parallel/mesh.py`` there) is a 1-D device
mesh driven by one process.  The port follows the reference training
script's own launch model instead: one OS process per GPU, rendezvousing
over ``torch.distributed`` (``Part 2a/main.py:148-153``: MASTER_ADDR, port
6585, ``init_process_group``).  The backend follows the device: NCCL on
``cuda``, gloo on ``cpu``, and never the one in place of the other.

A process that no launcher started gets a world-1 group in the process
(``initialize_distributed()`` with no address), so every strategy runs on
one card, as the reference package runs ``allreduce`` on a 1-device mesh.

The elastic coordinator's device helpers are here too: ``probe_devices``
(a round trip to each member's device) and ``surviving_members`` (the
devices of the next, smaller world), the reference's ``probe_devices``
and ``shrink_mesh``.
"""

from __future__ import annotations

import gc
from collections import Counter
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..device import resolve_device

DEFAULT_PORT = 6585   # the reference hardcodes it (Part 2a/main.py:172)


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(master: Optional[str] = None,
                           num_processes: int = 1, rank: int = 0,
                           port: int = DEFAULT_PORT,
                           device: Optional[Union[str, torch.device]] = None,
                           *, init_method: Optional[str] = None,
                           local_rank: Optional[int] = None) -> torch.device:
    """Join (or create) the default process group; returns this rank's
    device.

    ``master`` is the rendezvous host (``host`` or ``host:port``), or give
    ``init_method`` (for example a ``file://`` path) instead.  A
    multi-process run without either raises, as the reference makes
    ``--master`` required.  One process with neither gets a world-1 group
    in the process.  On ``cuda`` the process takes GPU ``local_rank``
    (default ``rank`` modulo the GPUs present) before the group forms.  A
    group that exists already is reused if its backend fits ``device`` and
    refused otherwise."""
    dev = resolve_device(device)
    backend = backend_for(dev)
    if dist.is_initialized():
        check_backend(dev)
        if num_processes > 1 and dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"a process group of world {dist.get_world_size()} exists; "
                f"cannot join one of world {num_processes}")
        return _current(dev)
    if num_processes < 1 or not 0 <= rank < num_processes:
        raise ValueError(f"rank {rank} out of range for world "
                         f"{num_processes}")
    if num_processes > 1 and master is None and init_method is None:
        raise ValueError(f"multi-process run (num_processes = "
                         f"{num_processes}) requires a master address")
    kwargs = {}
    if dev.type == "cuda":
        local = rank % torch.cuda.device_count() if local_rank is None \
            else local_rank
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        kwargs["device_id"] = dev
    if init_method is None and master is None:
        kwargs["store"] = dist.HashStore()
    elif init_method is None:
        addr = master if ":" in master else f"{master}:{port}"
        init_method = f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=num_processes, **kwargs)
    return dev


def destroy_distributed() -> None:
    """Destroy the default process group once nothing holds its
    collectives: the Trainers of this process, whose captured CUDA graphs
    hold NCCL kernels (a window's graph and its step form a reference
    cycle, so they are collected here), are gone first, and the device is
    idle.  The caller drops its references to them before."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dist.destroy_process_group()


def _current(dev: torch.device) -> torch.device:
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def check_backend(device: torch.device) -> None:
    """Raise unless the default group's backend is the one ``device``
    needs (NCCL for cuda, gloo for cpu)."""
    have, want = dist.get_backend(), backend_for(device)
    if have != want:
        raise RuntimeError(f"the process group runs {have}, but the "
                           f"{device.type} device needs {want}")


class Collective(NamedTuple):
    """One collective of a step, in issue order: its ``Group`` kind, the
    bytes of its result, its link and whether a strategy count holds it
    (``all_reduce_uncounted`` is recorded but not counted)."""
    kind: str
    nbytes: int
    link: int
    counted: bool


class _Waited:
    """An asynchronous collective's work: ``wait()`` also closes the
    group's open link, so that the next collective starts a new one."""

    def __init__(self, work, group: "Group"):
        self.work, self.group = work, group

    def wait(self):
        self.group._open = False
        return self.work.wait() if self.work is not None else True


class Group:
    """The default process group, as the strategies see it: every
    collective a strategy calls goes through one of these methods, which
    count it by kind, since the last ``reset_step()`` (``step_counts``)
    and in all (``total_counts``), and the bytes of its result by kind
    (``step_bytes``, ``total_bytes``: what ``all_reduce`` reduced in place,
    the ``world`` tensors ``gather`` collects, what ``scatter`` and
    ``all_gather`` write).

    Each collective since the last ``reset_step()`` is also recorded in
    issue order (``step_links``, ``Collective`` records) with its LINK: a
    blocking collective is a link of its own, and asynchronous ones issued
    one after the other before any of them is waited share one.  The
    links run one after the other (eager collectives run in issue order),
    so the step's chain depth is its number of links
    (``analysis/stats.py::collective_chain_depth``).

    The counts are kept on the host, so a step captured in a CUDA graph
    counts its collectives once, at capture; each replay then adds the
    captured step's counts (``add_replayed``), so that both counts mean
    collectives executed on either path."""

    KINDS = ("all_reduce", "all_reduce_max", "gather", "scatter",
             "all_gather")
    # Each kind under the name of the XLA collective the reference's
    # telemetry counts in its step's HLO (a MAX all-reduce is an
    # all-reduce there); gather and scatter have none and keep theirs.
    OP_NAMES = {"all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
                "gather": "gather", "scatter": "scatter",
                "all_gather": "all-gather"}

    def __init__(self, device: Optional[torch.device] = None):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "initialize_distributed first")
        if device is not None:
            check_backend(device)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.step_counts: Counter = Counter()
        self.total_counts: Counter = Counter()
        self.step_bytes: Counter = Counter()
        self.total_bytes: Counter = Counter()
        self.reset_step()

    def _count(self, kind: str, nbytes: int, async_op: bool = False) -> None:
        self.step_counts[kind] += 1
        self.total_counts[kind] += 1
        self.step_bytes[kind] += nbytes
        self.total_bytes[kind] += nbytes
        self._record(kind, nbytes, True, async_op)

    def _record(self, kind: str, nbytes: int, counted: bool,
                async_op: bool = False) -> None:
        if not (async_op and self._open):
            self._links += 1
        self._open = async_op
        self.step_links.append(Collective(kind, nbytes, self._links,
                                          counted))

    def reset_step(self) -> None:
        self.step_counts = Counter()
        self.step_bytes = Counter()
        self.step_links: List[Collective] = []
        self._links = 0
        self._open = False

    def add_replayed(self, step: Counter, step_bytes: Counter,
                     links: Sequence[Collective] = ()) -> None:
        """Count one replay of a captured step whose collectives were
        ``step``, of ``step_bytes`` result bytes, recorded as ``links``."""
        self.step_counts = Counter(step)
        self.total_counts.update(step)
        self.step_bytes = Counter(step_bytes)
        self.total_bytes.update(step_bytes)
        self.step_links = list(links)

    def all_reduce(self, t: torch.Tensor, async_op: bool = False):
        """Sum ``t`` over the ranks, in place; with ``async_op`` the work,
        whose ``wait()`` ends the collectives' shared link."""
        self._count("all_reduce", _nbytes(t), async_op)
        work = dist.all_reduce(t, async_op=async_op)
        return _Waited(work, self) if async_op else work

    def all_reduce_max(self, t: torch.Tensor) -> None:
        """Element-wise maximum of ``t`` over the ranks, in place."""
        self._count("all_reduce_max", _nbytes(t))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)

    def gather(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's ``t`` on rank 0 (in rank order); None elsewhere."""
        self._count("gather", self.world * _nbytes(t))
        out = [torch.empty_like(t) for _ in range(self.world)] \
            if self.rank == 0 else None
        dist.gather(t, out, dst=0)
        return out

    def scatter(self, out: torch.Tensor,
                chunks: Optional[Sequence[torch.Tensor]]) -> None:
        """Rank r receives rank 0's ``chunks[r]`` into ``out``."""
        self._count("scatter", _nbytes(out))
        dist.scatter(out, list(chunks) if self.rank == 0 else None, src=0)

    def all_gather(self, out: torch.Tensor, t: torch.Tensor) -> None:
        """Every rank's ``t`` concatenated along dim 0 in rank order, into
        ``out`` (``world * t.shape[0]`` rows), on every rank."""
        self._count("all_gather", _nbytes(out))
        all_gather_into(out, t)

    def all_reduce_uncounted(self, t: torch.Tensor) -> None:
        """Sum ``t`` over the ranks, in place, outside the counts: what
        every tier means over the ranks besides the gradients (the BN
        statistics and the loss, ``train/step.py::mean_over_ranks``; the
        eval counts) is no strategy's collective.  ``step_links`` records
        it."""
        self._record("all_reduce", _nbytes(t), False)
        dist.all_reduce(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_into(out: torch.Tensor, t: torch.Tensor) -> None:
    """``torch.distributed``'s single-tensor all-gather (rank-order
    concatenation along dim 0) under the name this torch gives it."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, t)


def probe_devices(indices: Sequence[int],
                  device_type: str = "cuda") -> List[int]:
    """Health-probe the local devices ``indices`` (the members of a world,
    rank order): a tiny round trip to each, returning the RANKS (positions
    in ``indices``) whose probe failed.  The elastic coordinator's
    liveness check (the reference's ``mesh.probe_devices``); on the CPU
    each member is a process slot and always passes."""
    dead = []
    for rank, index in enumerate(indices):
        dev = torch.device("cuda", index) if device_type == "cuda" \
            else torch.device("cpu")
        try:
            if int(torch.full((), rank, device=dev).cpu()) != rank:
                dead.append(rank)
        except Exception:  # noqa: BLE001 - any failure marks the rank dead
            dead.append(rank)
    return dead


def surviving_members(members: Sequence[int], new_world: int,
                      exclude: Sequence[int] = ()) -> Tuple[int, ...]:
    """The first ``new_world`` members (local device indices) that are not
    in ``exclude``, in their order: the devices of the next, smaller world
    (the reference's ``mesh.shrink_mesh``).  Survivors keep their relative
    order, so a rank's identity is stable across the shrink."""
    gone = set(exclude)
    survivors = [m for m in members if m not in gone]
    if new_world < 1:
        raise ValueError(f"new world must be >= 1, got {new_world}")
    if new_world > len(survivors):
        raise ValueError(f"cannot shrink to world {new_world}: only "
                         f"{len(survivors)} of {len(members)} members "
                         f"survive")
    return tuple(survivors[:new_world])
