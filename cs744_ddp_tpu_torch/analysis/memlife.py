"""Peak live device bytes of one call of a program, on meta tensors: the
counterpart of the reference package's liveness certifier
(``analysis/memlife.py``), over the storages one call allocates instead
of the buffers of an HLO module.

How it measures: ``MemTracer`` is a ``TorchDispatchMode``.  Every storage
an operator returns on the traced device is tracked from that operator to
its release, which ``weakref.finalize`` on the untyped storage reports
(so a view's storage counts once, and whatever autograd saves for
backward stays live until backward frees it).  The live bytes are read
after every operator, with its inputs and outputs live.  The ENTRY state
(the tensors the step carries: parameters, momentum, BN buffers, comm
state, a window's indices, losses and ring) is held by the caller for the
whole call and counted throughout, as the reference counts entry
parameters.

**In-place state is the port's donation.**  A captured step reads its
state at fixed addresses, so every state leaf must be updated in place:
same storage before and after (proven by storage identity, not address:
a meta tensor has none).  A leaf the step REBINDS to a fresh storage
costs that storage for the whole call in this model, as the reference
charges the carry copy of an undonated ``while``: the caller (the
captured graph) still holds the entry storage while the fresh one is the
state the next step reads.  So a step that rebinds a leaf peaks exactly
that leaf's bytes higher (``rebound_bytes``) than its in-place twin.

What the bound does NOT see: cuDNN's and cuBLAS's workspaces, NCCL's
buffers, temporaries an operator allocates and frees inside its kernel,
the caching allocator's rounding and fragmentation (``max_memory_
allocated`` counts blocks, not tensors), and a CUDA graph's private pool
holding the intermediates of every captured step at once.  It is a model
of the tensors, NOT an upper bound on ``torch.cuda.max_memory_
allocated``; the audit holds it against the card's capacity
(``costmodel.H100_HBM_CAPACITY_BYTES``, assigned once, in
``analysis/costmodel.py``: ``check_memory``).

No counterpart: the reference's HLO-fixture invariants
(``check_fixture_invariants``) and its differential check against
``compiled.memory_analysis()``, since nothing the port runs produces HLO;
``check_memory`` proves the rebinding delta on a live seeded step instead.
"""

from __future__ import annotations

import os
import re
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .costmodel import _tensors
from .pylint_rules import LintFinding

#: How many of the fattest storages the peak's live set names.
TOP_MEMBERS = 8


@dataclass
class MemReport:
    """Static memory certificate for one program."""

    name: str
    peak_bytes: int = 0
    entry_bytes: int = 0              # caller-held: state and inputs
    state_bytes: int = 0              # the state leaves' bytes after
    rebound_bytes: int = 0            # leaves rebound to fresh storage
    transient_peak_bytes: int = 0     # peak beyond the entry and rebound
    output_bytes: int = 0             # storages the call leaves live
    # The fattest live set: {"position", "op", "live_bytes", "members":
    # [[storage, bytes], ...]}, the "what do I shrink" view.
    top_sets: List[Dict] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    @property
    def peak_mib(self) -> float:
        return self.peak_bytes / 2**20

    def to_dict(self) -> Dict:
        def mib(b):
            return round(b / 2**20, 3)
        return {
            "name": self.name,
            "peak_mib": mib(self.peak_bytes),
            "entry_mib": mib(self.entry_bytes),
            "state_mib": mib(self.state_bytes),
            "rebound_mib": mib(self.rebound_bytes),
            "transient_peak_mib": mib(self.transient_peak_bytes),
            "output_mib": mib(self.output_bytes),
            "top_sets": [
                {**t, "live_mib": mib(t["live_bytes"]),
                 "members": [[n, mib(b)] for n, b in t["members"]]}
                for t in self.top_sets],
            "notes": list(self.notes),
        }


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its ``StorageImpl``)."""
    return t.untyped_storage()._cdata


class MemTracer(TorchDispatchMode):
    """Tracks the storages a call allocates on ``device`` (module
    docstring).  ``entry``: the caller-held state, named; ``report()``
    after the call, given the state as it is then.

    A storage is known by a serial number while it lives: the address of
    a freed ``StorageImpl`` is reused by later ones."""

    def __init__(self, entry: Dict[str, torch.Tensor],
                 device: str = "meta"):
        super().__init__()
        self.device = torch.device(device)
        self.entry = {n: storage_key(t) for n, t in entry.items()}
        self._entry_bytes = {storage_key(t): t.untyped_storage().nbytes()
                             for t in entry.values()}
        self.position = 0
        self.end = 0
        self._serial: Dict[int, int] = {}       # live storage -> serial
        self.live: Dict[int, int] = {}          # serial -> bytes
        self.names: Dict[int, str] = {}         # serial -> "op#position"
        self.events: List[Tuple[int, int, int]] = []  # (pos, serial, delta)
        self._foreign: Dict[int, bool] = {}
        self._active = True

    def _free(self, key: int, serial: int) -> None:
        if self._serial.get(key) == serial:
            del self._serial[key]
        if self._active and serial in self.live:
            self.events.append((self.position, serial,
                                -self.live.pop(serial)))

    def _unforeign(self, key: int) -> None:
        self._foreign.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # Storages that existed before the call and are not entry state
        # (inputs the caller made): not this call's allocations.
        for t in _tensors((args, kwargs)):
            if t.device != self.device:
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key not in self._serial and key not in self._entry_bytes \
                    and key not in self._foreign:
                self._foreign[key] = True
                weakref.finalize(storage, self._unforeign, key)
        out = func(*args, **kwargs)
        for t in _tensors(out):
            if t.device != self.device:
                continue
            storage = t.untyped_storage()
            key, nbytes = storage._cdata, storage.nbytes()
            if key in self._entry_bytes or key in self._foreign:
                continue
            serial = self._serial.get(key)
            if serial is None:
                serial = self._serial[key] = len(self.names)
                self.live[serial] = 0
                self.names[serial] = \
                    f"{func.overloadpacket.__name__}#{self.position}"
                weakref.finalize(storage, self._free, key, serial)
            if nbytes > self.live[serial]:          # new, or resized
                self.events.append((self.position, serial,
                                    nbytes - self.live[serial]))
                self.live[serial] = nbytes
        self.position += 1
        return out

    def __exit__(self, *exc):
        self.end = self.position
        return super().__exit__(*exc)

    def report(self, name: str, state: Dict[str, torch.Tensor]
               ) -> MemReport:
        """The certificate, ``state`` the leaves after the call (the same
        names as the entry)."""
        self._active = False
        rep = MemReport(name=name,
                        entry_bytes=sum(self._entry_bytes.values()))
        after = {n: storage_key(t) for n, t in state.items()}
        moved = sorted(n for n in after if after[n] != self.entry.get(n))
        rebound = {self._serial[after[n]] for n in moved
                   if after[n] in self._serial}
        sizes = {storage_key(t): t.untyped_storage().nbytes()
                 for t in state.values()}
        rep.state_bytes = sum(sizes.values())
        rep.rebound_bytes = sum(sizes[after[n]] for n in moved
                                if after[n] not in self._entry_bytes)
        rep.output_bytes = sum(self.live.values())
        # The transient curve, the rebound leaves' storages left out (they
        # are charged for the whole call).
        n = max(self.end, 1)
        delta = [0] * (n + 1)
        for pos, serial, d in self.events:
            if serial not in rebound:
                delta[min(pos, n)] += d
        live, running, peak_pos = [], 0, 0
        for pos in range(n):
            running += delta[pos]
            live.append(running)
            if running > live[peak_pos]:
                peak_pos = pos
        rep.transient_peak_bytes = max(live)
        rep.peak_bytes = rep.entry_bytes + rep.transient_peak_bytes \
            + rep.rebound_bytes
        size: Dict[int, int] = {}
        for pos, serial, d in self.events:
            if pos <= peak_pos and serial not in rebound:
                size[serial] = size.get(serial, 0) + d
        members = sorted(((self.names[k], b) for k, b in size.items()
                          if b > 0), key=lambda kv: kv[1],
                         reverse=True)[:TOP_MEMBERS]
        rep.top_sets.append({"position": peak_pos,
                             "live_bytes": rep.peak_bytes,
                             "members": members})
        if moved:
            rep.notes.append(
                f"{len(moved)} state leaf(s) rebound to fresh storage "
                f"({rep.rebound_bytes} B, charged for the whole call): "
                f"{', '.join(moved[:4])}")
        return rep


def mem_report(fn: Callable, *args, state: Dict[str, torch.Tensor],
               name: str = "program",
               state_after: Optional[Callable[[], Dict[str, torch.Tensor]]]
               = None, **kwargs) -> MemReport:
    """The certificate of one call ``fn(*args, **kwargs)`` on meta
    tensors; ``state`` the caller-held leaves by name, ``state_after``
    what they are after the call (default: ``state`` itself)."""
    tracer = MemTracer(state)
    with tracer:
        fn(*args, **kwargs)
    return tracer.report(name, state_after() if state_after else state)


def rebound_leaves(entry: Dict[str, int],
                   after: Dict[str, torch.Tensor]) -> List[str]:
    """The names of the leaves whose storage changed over the call
    (``entry``: name -> ``storage_key`` before)."""
    return sorted(n for n, t in after.items()
                  if storage_key(t) != entry.get(n))


# ---------------------------------------------------------------------------
# Repo self-checks (the lint entry's path-less run)
# ---------------------------------------------------------------------------

_HOME = os.path.join("cs744_ddp_tpu_torch", "analysis", "costmodel.py")
_CAPACITY_ASSIGN_RE = re.compile(r"^\s*H100_HBM_CAPACITY_BYTES\s*=",
                                 re.MULTILINE)
_SCAN_DIRS = ("cs744_ddp_tpu_torch",)
_SCAN_FILES = ("chip_smoke.py",)


def _py_files(repo_root: str):
    for d in _SCAN_DIRS:
        for dirpath, dirnames, names in os.walk(os.path.join(repo_root, d)):
            dirnames[:] = [x for x in dirnames if x != "__pycache__"]
            for fn in sorted(names):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)
    for fn in _SCAN_FILES:
        path = os.path.join(repo_root, fn)
        if os.path.exists(path):
            yield path


def check_constants_single_source(repo_root: str) -> List[LintFinding]:
    """``H100_HBM_CAPACITY_BYTES``, the budget every memory check holds
    against, is assigned exactly once, in ``analysis/costmodel.py``."""
    findings: List[LintFinding] = []
    home = os.path.abspath(os.path.join(repo_root, _HOME))
    in_home = 0
    for path in _py_files(repo_root):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for m in _CAPACITY_ASSIGN_RE.finditer(text):
            if os.path.abspath(path) == home:
                in_home += 1
                continue
            findings.append(LintFinding(
                "memory-constants", path, text.count("\n", 0, m.start()) + 1,
                f"H100_HBM_CAPACITY_BYTES assigned outside {_HOME}; import "
                f"it from analysis.costmodel"))
    if in_home != 1:
        findings.append(LintFinding(
            "memory-constants", home, 0,
            f"H100_HBM_CAPACITY_BYTES must be assigned exactly once in "
            f"{_HOME} (found {in_home})"))
    return findings


def _seeded_step(rebind: bool):
    """A two-leaf SGD step on meta tensors (a 64x32 weight and its
    momentum), updating the momentum in place or rebinding it."""
    w = torch.empty((64, 32), device="meta")
    mom = torch.zeros_like(w)
    x = torch.empty((16, 64), device="meta")
    state = {"w": w, "mom": mom}

    def step():
        grad = x.t() @ (x @ state["w"])
        if rebind:
            state["mom"] = torch.add(grad, state["mom"], alpha=0.9)
        else:
            state["mom"].mul_(0.9).add_(grad)
        state["w"].sub_(state["mom"], alpha=0.1)

    return step, state


def donation_delta() -> Tuple[MemReport, MemReport]:
    """The in-place and the rebinding twin of ``_seeded_step``'s
    certificates."""
    reports = []
    for rebind in (False, True):
        step, state = _seeded_step(rebind)
        reports.append(mem_report(
            step, state=dict(state), state_after=lambda s=state: dict(s),
            name="seeded/" + ("rebind" if rebind else "in-place")))
    return reports[0], reports[1]


def check_donation_delta() -> List[LintFinding]:
    """Re-prove the donation delta in bytes on the seeded step: the
    rebinding twin peaks exactly the rebound leaf's bytes above the
    in-place one."""
    inplace, rebind = donation_delta()
    leaf = 64 * 32 * 4
    if inplace.rebound_bytes or rebind.rebound_bytes != leaf \
            or rebind.peak_bytes - inplace.peak_bytes != leaf:
        return [LintFinding(
            "memory-donation", __file__, 0,
            f"donation delta broke: in-place peak {inplace.peak_bytes}, "
            f"rebinding peak {rebind.peak_bytes}, rebound "
            f"{rebind.rebound_bytes} B, leaf {leaf} B")]
    return []


def check_memory(repo_root: str) -> List[LintFinding]:
    """What the path-less lint run certifies about memory: the capacity
    constant single-sourced, and the donation delta in bytes."""
    return check_constants_single_source(repo_root) + check_donation_delta()
