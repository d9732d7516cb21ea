"""Rule engine certifying every program the port dispatches: the
counterpart of the reference package's ``analysis/audit.py``, over the
aten-operator trace of each program run once on meta tensors instead of
its HLO lowering.

The reference certifies XLA lowerings; the port has none to read.  Its
programs are the step bodies a CUDA graph captures (one replay of a train
window, ``train/step.py::TrainWindow``, on the device-augment and the
host-augment path), the per-step path's eager step, the eval program and
the serving forward of each bucket (``models/serving.py::
make_u8_forward``).  Each is built on a meta twin of the model
(``costmodel.meta_model``) with a ``costmodel.CountingGroup`` in place of
the process group, at any world, and run once under a
``TorchDispatchMode``: VGG-11 at batch 256 costs no arithmetic, and no
card.

Rules (each one catches a seeded violation in
``tests/test_torch_port_audit.py``):

- ``collective-contract`` — per strategy, over the counted step's link
  record (``analysis/stats.py``): ``single``, eval and serving issue no
  strategy collective (eval's one uncounted sum of its counts at world >
  1); ``gather`` gathers and scatters every leaf, two links a leaf, with
  world-amplified gather bytes; ``allreduce`` one all-reduce and one link
  a leaf; ``ddp`` one per bucket, strictly shallower than per leaf; the
  ``overlap`` tier keeps ddp's buckets in ONE link and, with two buckets
  or more, issues one before the step's last ``convolution_backward`` (the
  counterpart of the reference's dot cones: a bucket launched from inside
  backward);
  the compressed tiers keep their wire bytes under ``param_bytes /
  compress_ratio`` (+ ``aux_bytes`` for the BN statistics and loss mean
  and the int8 shared-scale max).  The depth ladder ddp < allreduce <
  gather is certified whenever several tiers are audited together.
- ``dtype-leak`` — no f32/f64 ``convolution``, ``convolution_backward``
  or ``mm``/``addmm``/``bmm``/``linear`` of the model in a bf16 program.
  The gradient-sync strategies' own products (PowerSGD's, on f32
  gradients by the precision contract) are not the model's compute: a
  product run with grad mode on, outside backward and on no tensor that
  requires grad is the strategy's.
- ``donation`` — every state leaf keeps its storage over the call: a
  captured step must find its state at the addresses it was captured
  with (``memlife``: in-place state is the port's donation).
- ``peak-memory`` — the peak live bytes of the call
  (``memlife.MemTracer``) fit ``hbm_budget_bytes`` (the H100's 80 GB,
  ``costmodel.H100_HBM_CAPACITY_BYTES``).
- ``host-sync`` — no ``aten._local_scalar_dense`` (``.item()``), copy to
  the host or other synchronizing operator inside the program.  Caught in
  the dispatch mode BEFORE it runs (a meta tensor has no value to read),
  answered with a placeholder so the trace goes on.
- ``baked-constants`` — no tensor above ``max_constant_bytes`` made from
  host data inside the program (weights and data arrive as arguments).
- ``ingest-edge`` — a serving rung takes uint8 images at its edge and
  converts them to float in the program.

Waiver syntax (CLI ``--audit-waive``, tests): ``RULE`` waives a rule
everywhere, ``RULE@GLOB`` only for programs matching the fnmatch glob,
e.g. ``baked-constants@serve/*``.  Waived findings are still reported and
recorded in the telemetry manifest; they just don't fail ``--audit
strict``.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import costmodel, memlife, stats
from .costmodel import H100_HBM_CAPACITY_BYTES, _tensors

DEFAULT_MAX_CONSTANT_BYTES = 1 << 20     # 1 MiB: far above any scalar or
                                         # table, far below weights/data
#: The world the zoo is audited at unless the caller names one: the port's
#: four-card box (a ``CountingGroup`` needs no process group or card).
DEFAULT_WORLD = 4
STRATEGIES = ("single", "gather", "allreduce", "ddp", "overlap",
              "compress-bf16", "compress-int8", "powersgd")
PATHS = ("step", "window", "host_window")

_DOTS = frozenset(("convolution", "convolution_backward", "mm", "addmm",
                   "bmm", "baddbmm", "linear"))
# Operators that wait for the device: a value read to the host, or an
# output whose shape depends on the data.
_SYNC_OPS = frozenset(("_local_scalar_dense", "item", "is_nonzero",
                       "equal", "nonzero", "masked_select"))
_COPIES = frozenset(("_to_copy", "copy_"))


@dataclass(frozen=True)
class Finding:
    rule: str
    program: str
    message: str


@dataclass
class ProgramContract:
    """What a program's trace is REQUIRED to look like."""
    name: str
    strategy: Optional[str] = None       # single/gather/allreduce/ddp/
                                         # overlap/compress-*/powersgd/eval;
                                         # None = no collectives expected
    world: int = 1
    nleaves: int = 0                     # parameter (grad) leaves
    nbuckets: int = 0                    # ddp bucket count
    param_bytes: int = 0                 # total parameter bytes (f32)
    n_state_leaves: int = 0              # leaves held at fixed storage
    donates_state: bool = False          # state updated in place
    precision: str = "f32"
    max_constant_bytes: int = DEFAULT_MAX_CONSTANT_BYTES
    compress_ratio: float = 1.0          # required param_bytes / grad wire
    aux_bytes: int = 0                   # non-gradient collective allowance
                                         # (BN and loss mean, int8 max)
    u8_edge: bool = False                # fused-ingest contract: uint8
                                         # images at the program edge,
                                         # normalize in-program
    hbm_budget_bytes: int = H100_HBM_CAPACITY_BYTES


@dataclass
class Program:
    """One program of the zoo, built on meta tensors: ``fn()`` is one
    call (one replay of a window's captured step, one eager step, the eval
    or one serving dispatch); ``leaves()`` the state it carries, by name;
    ``inputs`` its device inputs (held by the caller for the call);
    ``group`` the ``CountingGroup`` it was built with; ``window`` the
    ``TrainWindow`` of a windowed path (``dispatch.certify_program``)."""
    name: str
    fn: Callable[[], object]
    leaves: Callable[[], Dict[str, torch.Tensor]]
    inputs: Dict[str, torch.Tensor]
    contract: ProgramContract
    group: Optional[costmodel.CountingGroup] = None
    window: object = None


@dataclass
class AuditReport:
    program: str
    findings: List[Finding] = field(default_factory=list)
    waived: List[Finding] = field(default_factory=list)
    rules: Dict[str, str] = field(default_factory=dict)  # rule -> pass/fail/waived
    stats: Dict = field(default_factory=dict)            # collective shape record

    @property
    def passed(self) -> bool:
        return not self.findings


def _waived(finding: Finding, waivers: Sequence[str]) -> bool:
    for w in waivers:
        rule, _, prog_glob = w.partition("@")
        if rule != finding.rule:
            continue
        if not prog_glob or fnmatch.fnmatch(finding.program, prog_glob):
            return True
    return False


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

class Trace(TorchDispatchMode):
    """What the rules read from one call: the model's dots with their
    result dtypes, the host syncs (intercepted), the host data copied in, the
    in-program uint8-to-float conversions and the positions of
    ``convolution_backward``; ``position`` counts the operators and is the
    ``CountingGroup``'s clock."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = torch.device(device)
        self.position = 0
        self.dots: List[Tuple[str, torch.dtype]] = []
        self.syncs: List[str] = []
        self.constants: List[Tuple[str, int]] = []
        self.u8_converts = 0
        self.conv_backward: List[int] = []

    def _on(self, t) -> bool:
        return isinstance(t, torch.Tensor) and t.device == self.device

    def _sync(self, name, func, args, kwargs):
        """The synchronizing operator's placeholder result, or None when
        ``func`` does not synchronize."""
        if name in _SYNC_OPS:
            self.syncs.append(name)
            x = args[0]
            if name == "nonzero":
                return torch.empty((0, x.dim()), dtype=torch.int64,
                                   device=self.device)
            if name == "masked_select":
                return torch.empty((0,), dtype=x.dtype, device=self.device)
            return False if x.dtype == torch.bool else \
                (0.0 if x.is_floating_point() else 0)
        if name == "_to_copy" and self._on(args[0]) and \
                torch.device(kwargs.get("device") or args[0].device) \
                != self.device:
            self.syncs.append(f"{name} to the host")
            return torch.empty(args[0].shape,
                               dtype=kwargs.get("dtype") or args[0].dtype)
        if name == "copy_" and self._on(args[1]) and not self._on(args[0]):
            self.syncs.append(f"{name} to the host")
            return args[0]
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        fake = self._sync(name, func, args, kwargs)
        if fake is not None:
            self.position += 1
            return fake
        if name in _COPIES:
            src = args[0] if name == "_to_copy" else args[1]
            if isinstance(src, torch.Tensor) and not self._on(src):
                self.constants.append(
                    (name, src.numel() * src.element_size()))
        out = func(*args, **kwargs)
        if name in _DOTS:
            res = out[0] if isinstance(out, (tuple, list)) else out
            model = (torch._C._current_graph_task_id() != -1
                     or not torch.is_grad_enabled()
                     or any(t.requires_grad
                            for t in _tensors((args, kwargs))))
            if isinstance(res, torch.Tensor) and model:
                self.dots.append((name, res.dtype))
        if name == "convolution_backward":
            self.conv_backward.append(self.position)
        if any(t.dtype == torch.uint8 for t in _tensors((args, kwargs))
               if self._on(t)) and any(
                   t.is_floating_point() for t in _tensors(out)
                   if self._on(t)):
            self.u8_converts += 1
        self.position += 1
        return out


@dataclass
class Traced:
    """One program's call, as the rules see it."""
    trace: Trace
    mem: memlife.MemReport
    links: List                       # the step's Collective records
    issued: List                      # (Collective, position)
    rebound: List[str]
    leaves: int
    inputs: Dict[str, torch.Tensor]


def trace_program(program: Program, collect_costs: bool = False
                  ) -> Tuple[Traced, Optional[costmodel.CostReport]]:
    """Run ``program`` once under the trace and the memory tracer (and the
    cost model's counter when ``collect_costs``)."""
    trace = Trace()
    before = program.leaves()
    entry = {n: memlife.storage_key(t) for n, t in before.items()}
    mem = memlife.MemTracer({**before, **program.inputs})
    group = program.group
    start = 0
    if group is not None:
        group.clock = lambda: trace.position
        start = len(group.issued)

    def run():
        with mem, trace:
            program.fn()

    try:
        cost = costmodel.count(run, name=program.name, group=group) \
            if collect_costs else run()
    finally:
        if group is not None:
            group.clock = None
    after = program.leaves()
    issued = group.issued[start:] if group is not None else []
    traced = Traced(
        trace=trace,
        mem=mem.report(program.name, after),
        links=[c for c, _ in issued], issued=issued,
        rebound=memlife.rebound_leaves(entry, after), leaves=len(after),
        inputs=program.inputs)
    return traced, cost


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

def _rule_collective_contract(t: Traced, c: ProgramContract
                              ) -> List[Finding]:
    counted = [x for x in t.links if x.counted]
    counts: Dict[str, int] = {}
    for x in counted:
        counts[x.kind] = counts.get(x.kind, 0) + 1
    depth = stats.collective_chain_depth(t.links)
    by = stats.collective_bytes(t.links)
    out: List[Finding] = []

    def bad(msg: str) -> None:
        out.append(Finding("collective-contract", c.name, msg))

    if c.strategy is None or c.strategy == "single":
        if t.links:
            bad(f"expected a collective-free program, found "
                f"{[x.kind for x in t.links]} (chain depth {depth})")
        return out
    if c.strategy == "eval":
        if counted:
            bad(f"eval issues no strategy collective; found {counts}")
        kinds = {x.kind for x in t.links}
        if kinds - {"all_reduce"}:
            bad(f"eval must reduce only (all_reduce); found {kinds}")
        if c.world > 1 and not t.links:
            bad("eval on several ranks must sum its counts; found no "
                "all_reduce")
        if stats.collective_chain_depth(t.links, counted_only=False) > 2:
            bad("eval reductions must not serialize: chain depth > 2")
        return out
    if c.world <= 1:
        # A strategy on one rank keeps its collectives (the CLI's world-1
        # group); over one rank they are no-ops, not violations.
        return out

    ar = counts.get("all_reduce", 0) + counts.get("all_reduce_max", 0)
    ar_bytes = by.get("all-reduce", 0)
    others = {k: n for k, n in counts.items()
              if k not in ("all_reduce", "all_reduce_max")}

    if c.strategy == "gather":
        ga, sc = counts.get("gather", 0), counts.get("scatter", 0)
        if ga < c.nleaves or sc < c.nleaves:
            bad(f"gather tier must gather and scatter every grad leaf: "
                f"{ga} gather, {sc} scatter < {c.nleaves} leaves")
        if depth < 2 * c.nleaves:
            bad(f"gather tier chains two collectives per leaf: depth "
                f"{depth} < {2 * c.nleaves}")
        want = c.world * c.param_bytes
        if c.param_bytes and by.get("gather", 0) < want:
            bad(f"gather traffic amplification missing: gather result "
                f"bytes {by.get('gather', 0)} < world x params = {want}")
        return out

    if c.strategy in ("allreduce", "ddp", "overlap"):
        if others or counts.get("all_reduce_max"):
            bad(f"{c.strategy} tier must emit only all_reduce; found "
                f"{counts}")
        if c.param_bytes and ar_bytes < c.param_bytes:
            bad(f"all-reduce result bytes {ar_bytes} < total param bytes "
                f"{c.param_bytes}")
    if c.strategy == "allreduce":
        if ar < c.nleaves:
            bad(f"per-param tier reduces every leaf: {ar} all_reduce < "
                f"{c.nleaves} leaves")
        if depth < c.nleaves:
            bad(f"per-param tier chains one collective per leaf: depth "
                f"{depth} < {c.nleaves}")
        return out
    if c.strategy == "ddp":
        if ar < c.nbuckets:
            bad(f"ddp tier reduces every bucket: {ar} all_reduce < "
                f"{c.nbuckets} buckets")
        if depth < c.nbuckets:
            bad(f"ddp chain depth {depth} < {c.nbuckets} buckets")
        if c.nleaves > c.nbuckets and depth >= c.nleaves:
            bad(f"ddp fusion win lost: chain depth {depth} >= {c.nleaves} "
                f"leaves — bucketed reduces are serializing per leaf")
        return out
    if c.strategy == "overlap":
        if ar < c.nbuckets:
            bad(f"overlapped tier reduces every bucket: {ar} all_reduce < "
                f"{c.nbuckets} buckets")
        if depth > 1:
            bad(f"overlapped tier must not chain collectives: chain depth "
                f"{depth} > 1 — every bucket waits behind the one before")
        # With one bucket its last gradient is the first layer's: it can
        # only start once backward is done, whatever the tier does.
        issued = [pos for x, pos in t.issued if x.counted]
        last_bwd = max(t.trace.conv_backward, default=None)
        if c.nbuckets > 1 and last_bwd is not None and issued \
                and min(issued) > last_bwd:
            bad(f"no bucket is issued before the step's last "
                f"convolution_backward (position {last_bwd}; first bucket "
                f"at {min(issued)}) — every reduce waits for the whole "
                f"backward")
        return out

    if c.strategy in ("compress-bf16", "compress-int8", "powersgd"):
        if others:
            bad(f"compressed tier must emit only all_reduce; found "
                f"{counts}")
        if counts.get("all_reduce", 0) < c.nleaves:
            bad(f"compressed tier reduces every leaf: "
                f"{counts.get('all_reduce', 0)} all_reduce < {c.nleaves} "
                f"leaves")
        wire = stats.collective_bytes(t.links, counted_only=False).get(
            "all-reduce", 0)
        if wire <= 0:
            bad("compressed tier issued no all-reduce bytes")
        if c.param_bytes:
            grad_wire = max(0, wire - c.aux_bytes)
            ceiling = c.param_bytes / c.compress_ratio
            if grad_wire > ceiling:
                bad(f"compression is not real: gradient wire bytes "
                    f"{grad_wire} (total all-reduce {wire} - aux "
                    f"{c.aux_bytes}) exceed param_bytes / "
                    f"{c.compress_ratio:g}x = {ceiling:.0f}")
        return out

    bad(f"unknown strategy {c.strategy!r} in contract")
    return out


def _rule_dtype_leak(t: Traced, c: ProgramContract) -> List[Finding]:
    if c.precision != "bf16":
        return []
    return [Finding("dtype-leak", c.name,
                    f"{dtype} {name} in a bf16-declared program (a silent "
                    f"promotion runs it on the CUDA cores, off the tensor "
                    f"cores)")
            for name, dtype in t.trace.dots
            if dtype in (torch.float32, torch.float64)]


def _rule_donation(t: Traced, c: ProgramContract) -> List[Finding]:
    out: List[Finding] = []
    if not c.donates_state:
        return out
    if t.rebound:
        out.append(Finding(
            "donation", c.name,
            f"{len(t.rebound)} state leaf(s) rebound to fresh storage "
            f"(the captured step would read the old addresses; "
            f"+{t.mem.rebound_bytes} B peak): {', '.join(t.rebound[:6])}"))
    if t.leaves < c.n_state_leaves:
        out.append(Finding(
            "donation", c.name,
            f"{t.leaves} state leaves held in place, fewer than the "
            f"{c.n_state_leaves} the step carries"))
    return out


def _rule_peak_memory(t: Traced, c: ProgramContract) -> List[Finding]:
    budget = c.hbm_budget_bytes
    if t.mem.peak_bytes <= budget:
        return []
    top = t.mem.top_sets[0] if t.mem.top_sets else {}
    fattest = ", ".join(f"{n}={b}" for n, b in top.get("members", [])[:4])
    return [Finding(
        "peak-memory", c.name,
        f"static peak {t.mem.peak_bytes} B ({t.mem.peak_mib:.1f} MiB) "
        f"exceeds the {budget} B budget; fattest live set at operator "
        f"{top.get('position', '?')}: {fattest}")]


def _rule_host_sync(t: Traced, c: ProgramContract) -> List[Finding]:
    return [Finding("host-sync", c.name,
                    f"host sync {name} inside the program: the captured "
                    f"step cannot hold it, and the eager one waits for the "
                    f"card at every step")
            for name in t.trace.syncs]


def _rule_baked_constants(t: Traced, c: ProgramContract) -> List[Finding]:
    return [Finding("baked-constants", c.name,
                    f"{name} copies {nbytes} bytes of host data into the "
                    f"program (> {c.max_constant_bytes}); pass it as an "
                    f"argument")
            for name, nbytes in t.trace.constants
            if nbytes > c.max_constant_bytes]


def _rule_ingest_edge(t: Traced, c: ProgramContract) -> List[Finding]:
    if not c.u8_edge:
        return []
    out: List[Finding] = []
    images = [(n, x) for n, x in t.inputs.items()
              if x.dim() == 4 and tuple(x.shape[1:]) == (32, 32, 3)]
    for n, x in images:
        if x.dtype != torch.uint8:
            out.append(Finding(
                "ingest-edge", c.name,
                f"{x.dtype} image input {n!r} {tuple(x.shape)}: the "
                f"wire-to-device path must stay uint8 — a float image "
                f"input means the normalize left the program and the host "
                f"pays a 4x transfer"))
    if not any(x.dtype == torch.uint8 for _, x in images):
        out.append(Finding(
            "ingest-edge", c.name,
            "no uint8 image input: a fused-ingest rung must take the raw "
            "u8 wire bytes at the program edge"))
    elif not t.trace.u8_converts:
        out.append(Finding(
            "ingest-edge", c.name,
            "no in-program u8 -> float conversion: the program takes "
            "uint8 images but never normalizes them on the device"))
    return out


RULES = {
    "collective-contract": _rule_collective_contract,
    "dtype-leak": _rule_dtype_leak,
    "donation": _rule_donation,
    "host-sync": _rule_host_sync,
    "baked-constants": _rule_baked_constants,
    "ingest-edge": _rule_ingest_edge,
    "peak-memory": _rule_peak_memory,
}


def audit_program(program: Program, waive: Sequence[str] = (),
                  costs: Optional[Dict] = None,
                  mems: Optional[Dict] = None) -> AuditReport:
    """Run every rule over one program's call.  ``costs`` (a dict)
    collects its ``CostReport`` under its name; ``mems`` its
    ``MemReport``."""
    traced, cost = trace_program(program, collect_costs=costs is not None)
    if costs is not None:
        costs[program.name] = cost
    if mems is not None:
        mems[program.name] = traced.mem
    report = AuditReport(program=program.name)
    s = stats.collective_stats(traced.links)
    report.stats = {
        "collectives": {op: e["count"] for op, e in s["ops"].items()},
        "result_bytes": stats.collective_bytes(traced.links),
        "chain_depth": stats.collective_chain_depth(traced.links),
        "chain_depth_all": stats.collective_chain_depth(
            traced.links, counted_only=False),
        "state_leaves": traced.leaves,
        "rebound": len(traced.rebound),
        "peak_mib": round(traced.mem.peak_mib, 3),
    }
    for rule, fn in RULES.items():
        findings = fn(traced, program.contract)
        kept = [f for f in findings if not _waived(f, waive)]
        dropped = [f for f in findings if _waived(f, waive)]
        report.findings.extend(kept)
        report.waived.extend(dropped)
        report.rules[rule] = ("fail" if kept else
                              "waived" if dropped else "pass")
    return report


# ---------------------------------------------------------------------------
# The program zoo: every program the port dispatches, traced and audited
# ---------------------------------------------------------------------------

@dataclass
class AuditResult:
    reports: List[AuditReport] = field(default_factory=list)
    ladder: Dict = field(default_factory=dict)
    ladder_findings: List[Finding] = field(default_factory=list)
    # Program name -> the program, its memory certificate, and (when the
    # caller asks, ``collect_costs``) its cost-model report: the
    # attribution (``zoo_attribution``) and the dispatch certificate
    # (``dispatch.certify_zoo``) read the same calls the audit certified.
    programs: Dict[str, Program] = field(default_factory=dict)
    mem: Dict[str, memlife.MemReport] = field(default_factory=dict)
    costs: Dict[str, costmodel.CostReport] = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return (not self.ladder_findings
                and all(r.passed for r in self.reports))

    def findings(self) -> List[Finding]:
        out = [f for r in self.reports for f in r.findings]
        out.extend(self.ladder_findings)
        return out

    def waived(self) -> List[Finding]:
        return [f for r in self.reports for f in r.waived]

    def summary(self) -> Dict:
        """Manifest-ready record: per-program rule pass/fail + waivers,
        the strategy depth ladder, and every finding message."""
        return {
            "clean": self.clean,
            "n_programs": len(self.reports),
            "n_findings": len(self.findings()),
            "n_waived": len(self.waived()),
            "programs": {
                r.program: {"rules": r.rules, **r.stats}
                for r in self.reports},
            "findings": [
                {"rule": f.rule, "program": f.program,
                 "message": f.message[:300]}
                for f in self.findings()],
            "waived": [
                {"rule": f.rule, "program": f.program,
                 "message": f.message[:300]}
                for f in self.waived()],
            **({"ladder": self.ladder} if self.ladder else {}),
        }

    def format_lines(self) -> List[str]:
        lines = []
        for r in self.reports:
            mark = "PASS" if r.passed else "FAIL"
            extra = f"  waived={len(r.waived)}" if r.waived else ""
            lines.append(f"[audit] {mark} {r.program}  "
                         f"collectives={r.stats.get('collectives', {})} "
                         f"depth={r.stats.get('chain_depth')} "
                         f"peak_mib={r.stats.get('peak_mib')}{extra}")
            for f in r.findings + r.waived:
                tag = "waived " if f in r.waived else ""
                lines.append(f"[audit]   {tag}{f.rule}: {f.message}")
        for f in self.ladder_findings:
            lines.append(f"[audit] FAIL {f.program} {f.rule}: {f.message}")
        if self.ladder:
            lines.append(f"[audit] strategy depth ladder: {self.ladder}")
        lines.append(f"[audit] {'CLEAN' if self.clean else 'DIRTY'}: "
                     f"{len(self.reports)} programs, "
                     f"{len(self.findings())} findings, "
                     f"{len(self.waived())} waived")
        return lines


def _certify_ladder(depths: Dict[str, int], nleaves: int, nbuckets: int,
                    program: str) -> Tuple[Dict, List[Finding]]:
    """Cross-strategy certification: the paper's ordering of chain depths
    (bucketed ddp < per-param allreduce < chained gather) must hold on the
    traced programs themselves whenever several tiers are audited
    together on several ranks."""
    ladder = dict(depths)
    findings: List[Finding] = []

    def bad(msg):
        findings.append(Finding("collective-contract", program, msg))

    if "allreduce" in depths and "gather" in depths:
        if not depths["gather"] > depths["allreduce"]:
            bad(f"gather depth {depths['gather']} must exceed allreduce "
                f"depth {depths['allreduce']} (two chained collectives "
                f"per leaf vs one)")
    if "allreduce" in depths and "ddp" in depths and nleaves > nbuckets:
        if not depths["ddp"] < depths["allreduce"]:
            bad(f"ddp depth {depths['ddp']} must be shallower than "
                f"allreduce depth {depths['allreduce']} with {nbuckets} "
                f"buckets over {nleaves} leaves")
    return ladder, findings


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _dtype(precision: str) -> Optional[torch.dtype]:
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be f32 or bf16, got "
                         f"{precision!r}")
    return torch.bfloat16 if precision == "bf16" else None


def _compress_ratio(strategy: str, strat, params) -> float:
    """Analytic wire-byte reduction of a compressed tier on THIS model's
    leaf shapes (the reference's recipe, in its layout)."""
    from ..parallel.strategies import reference_shape
    param_bytes = sum(p.numel() * 4 for p in params)
    if strategy == "compress-bf16":
        return 2.0
    if strategy == "compress-int8":
        return 4.0
    if strategy == "powersgd":
        wire = 0
        for p in params:
            shape = reference_shape(p.shape)
            if strat._low_rank(shape):
                m = 1
                for d in shape[:-1]:
                    m *= d
                wire += 4 * strat.rank * (m + shape[-1])   # f32 P + Q
            else:
                wire += 2 * p.numel()                      # bf16 path
        return max(1.0, param_bytes / max(1, wire))
    return 1.0


def train_program(model: str, strategy: str, path: str, *, world: int,
                  global_batch: int, window: int, precision: str = "f32",
                  metrics_ring: bool = True, seed: int = 0,
                  contract: Optional[ProgramContract] = None) -> Program:
    """The train program of ``path`` (``step``: the per-step path's eager
    step; ``window``: one replay of the window's captured step;
    ``host_window``: the same over the host path's uint8 window buffer) at
    one rank's batch of ``global_batch`` over ``world`` (1 for
    ``single``), on meta tensors."""
    from ..obs import ringbuf
    from ..ops import sgd
    from ..parallel import get_strategy, strategies
    from ..train import step as steplib

    net = costmodel.meta_model(model, seed)
    strat = get_strategy(strategy)
    single = strat is strategies.local
    w = 1 if single else int(world)
    group = None if single else costmodel.CountingGroup(w)
    b = max(1, global_batch // w)
    state = steplib.init_train_state(net, strat)
    dt = _dtype(precision)
    cfg = sgd.SGDConfig()
    name = f"train/{path}/{strategy}"
    if path == "step":
        step = steplib.make_train_step(net, strat, cfg, augment=True,
                                       group=group, compute_dtype=dt)
        inputs = {"images": _meta((b, 32, 32, 3), torch.uint8),
                  "labels": _meta((b,), torch.int64),
                  "epoch": _meta((), torch.int64),
                  "idx": _meta((), torch.int64)}
        return Program(
            name, lambda: step.with_ok(state, *inputs.values()),
            lambda: steplib.named_state_tensors(state), inputs,
            contract or ProgramContract(name), group)
    if path not in ("window", "host_window"):
        raise ValueError(f"unknown train path {path!r}")
    body = steplib.make_step_body(
        net, strat, cfg, augment=True if path == "window" else "host_u8",
        group=group, compute_dtype=dt)
    win = steplib.TrainWindow(
        body, state, _meta((window, b, 32, 32, 3), torch.uint8),
        _meta((window, b), torch.int64), group=group,
        ring_capacity=ringbuf.DEFAULT_CAPACITY if metrics_ring else 0,
        buffered=path == "host_window")
    return Program(name, win.step.fn, win.named_tensors,
                   {"window/images": win.images, "window/labels": win.labels},
                   contract or ProgramContract(name), group, win)


def eval_program(model: str, *, world: int, global_batch: int,
                 window: int, precision: str = "f32", seed: int = 0,
                 contract: Optional[ProgramContract] = None) -> Program:
    """The eval program over ``window`` staged batches of one rank."""
    from ..train import step as steplib
    net = costmodel.meta_model(model, seed)
    group = costmodel.CountingGroup(world) if world > 1 else None
    b = max(1, global_batch // world)
    evaluate = steplib.make_eval_window(net, group, _dtype(precision))
    inputs = {"images": _meta((window, b, 32, 32, 3), torch.uint8),
              "labels": _meta((window, b), torch.int64)}
    return Program("eval/window", lambda: evaluate(*inputs.values()),
                   lambda: _model_tensors(net), inputs,
                   contract or ProgramContract("eval/window"), group)


def serve_program(model: str, bucket: int, precision: str = "f32", *,
                  seed: int = 0, prefix: str = "serve",
                  contract: Optional[ProgramContract] = None) -> Program:
    """One serving dispatch: ``make_u8_forward`` at ``bucket``."""
    from ..models.serving import make_u8_forward
    net = costmodel.meta_model(model, seed)
    forward = make_u8_forward(net, _dtype(precision))
    name = f"{prefix}/b{bucket}/{precision}"
    inputs = {"images": _meta((bucket, 32, 32, 3), torch.uint8),
              "labels": _meta((bucket,), torch.int64)}
    return Program(name, lambda: forward(*inputs.values()),
                   lambda: _model_tensors(net), inputs,
                   contract or ProgramContract(name, u8_edge=True,
                                               precision=precision))


def _model_tensors(net) -> Dict[str, torch.Tensor]:
    out = {f"model/{n}": p.detach() for n, p in net.named_parameters()}
    out.update((f"model/{n}", b) for n, b in net.named_buffers())
    return out


def audit_zoo(*, model: str = "vgg11", global_batch: int = 256,
              window: Optional[int] = None, precision: str = "f32",
              strategies: Sequence[str] = STRATEGIES,
              paths: Sequence[str] = PATHS,
              include_eval: bool = True,
              serve_buckets: Sequence[int] = (),
              serve_precision: Optional[str] = None,
              num_devices: Optional[int] = None,
              waive: Sequence[str] = (),
              max_constant_bytes: int = DEFAULT_MAX_CONSTANT_BYTES,
              metrics_ring: bool = True,
              collect_costs: bool = False,
              hbm_budget_bytes: int = H100_HBM_CAPACITY_BYTES,
              seed: int = 0) -> AuditResult:
    """Trace and audit the port's program zoo: the 3 train paths for each
    strategy, the eval program, and (when ``serve_buckets`` is non-empty)
    the serving ladder; every program on meta tensors, one rank's of a
    ``num_devices`` world (``DEFAULT_WORLD`` when None; ``single`` at
    world 1).  ``window`` (default the Trainer's 20) is the staged window
    of the windowed paths and the eval; ``metrics_ring`` (default on, as
    the Trainer) gives the windows their ring.  ``collect_costs`` keeps
    each program's ``CostReport`` (``AuditResult.costs``) for
    ``zoo_attribution``."""
    from ..models import get_model
    from ..parallel import get_strategy
    from ..parallel.bucketing import DEFAULT_BUCKET_BYTES, make_plan
    from ..utils.metrics import WINDOW

    window = WINDOW if window is None else int(window)
    world = DEFAULT_WORLD if num_devices is None else int(num_devices)
    params = list(get_model(model, seed).parameters())
    nleaves = len(params)
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    nbuckets = make_plan(params, DEFAULT_BUCKET_BYTES).num_buckets
    # Non-gradient collective allowance for the compressed-tier byte
    # ceilings: the BN statistics and loss mean, the int8 shared-scale max
    # (f32[nleaves]) and a slack word, as the reference allows.
    bn_bytes = sum(b.numel() * b.element_size()
                   for n, b in get_model(model, seed).named_buffers()
                   if n.endswith(("running_mean", "running_var")))
    aux_bytes = bn_bytes + 4 * nleaves + 1024
    result = AuditResult()
    costs = result.costs if collect_costs else None
    window_depths: Dict[str, int] = {}

    def contract(name, strategy, w, donates, ratio=1.0, n_state=0):
        return ProgramContract(
            name=name, strategy=strategy, world=w, nleaves=nleaves,
            nbuckets=nbuckets, param_bytes=param_bytes,
            n_state_leaves=n_state, donates_state=donates,
            precision=precision, max_constant_bytes=max_constant_bytes,
            compress_ratio=ratio, aux_bytes=aux_bytes,
            hbm_budget_bytes=hbm_budget_bytes)

    def audit(program):
        result.programs[program.name] = program
        result.reports.append(audit_program(program, waive, costs,
                                            result.mem))
        return result.reports[-1]

    for strategy in strategies:
        w = 1 if strategy == "single" else world
        ratio = _compress_ratio(strategy, get_strategy(strategy), params)
        for path in paths:
            program = train_program(
                model, strategy, path, world=w, global_batch=global_batch,
                window=window, precision=precision,
                metrics_ring=metrics_ring, seed=seed)
            program.contract = contract(program.name, strategy, w, True,
                                        ratio, len(program.leaves()))
            report = audit(program)
            if path == "window":
                window_depths[strategy] = report.stats["chain_depth"]

    if include_eval:
        program = eval_program(model, world=world,
                               global_batch=global_batch, window=window,
                               precision=precision, seed=seed)
        program.contract = contract("eval/window", "eval", world, False)
        audit(program)

    if serve_buckets:
        result.reports.extend(audit_serving(
            model=model, buckets=serve_buckets,
            precision=serve_precision or precision, waive=waive,
            max_constant_bytes=max_constant_bytes, costs=costs,
            mems=result.mem, programs=result.programs))

    if world > 1 and len(window_depths) > 1:
        ladder, findings = _certify_ladder(
            window_depths, nleaves, nbuckets,
            program="strategy-ladder(train/window)")
        result.ladder = ladder
        result.ladder_findings = [f for f in findings
                                  if not _waived(f, waive)]
    return result


def audit_serving(*, model: str = "vgg11",
                  buckets: Sequence[int] = (1, 8, 32, 128, 256),
                  precision: str = "f32", engine=None,
                  waive: Sequence[str] = (),
                  max_constant_bytes: int = DEFAULT_MAX_CONSTANT_BYTES,
                  costs: Optional[Dict] = None, mems: Optional[Dict] = None,
                  programs: Optional[Dict] = None) -> List[AuditReport]:
    """Audit the serving ladder: one program per bucket
    (``make_u8_forward`` on a meta twin of the model), required
    collective-free, precision-certified, constant-lean and fused-ingest
    certified (``ingest-edge``).  Pass ``engine`` (an ``InferenceEngine``)
    to audit its ladder: its model and buckets."""
    if engine is not None:
        model, buckets = engine.model_name, engine.buckets
    reports = []
    for b in buckets:
        name = f"serve/b{b}/{precision}"
        program = serve_program(model, b, precision, contract=ProgramContract(
            name=name, strategy=None, world=1, precision=precision,
            max_constant_bytes=max_constant_bytes, u8_edge=True))
        if programs is not None:
            programs[name] = program
        reports.append(audit_program(program, waive, costs, mems))
    return reports


def record_audit(telemetry, result: AuditResult) -> None:
    """Attach the audit summary to the run manifest.  The disabled
    recorder path allocates and touches NOTHING."""
    if not getattr(telemetry, "enabled", False):
        return
    telemetry.update_manifest({"audit": result.summary()})


def zoo_attribution(result: AuditResult) -> Dict:
    """Cost-model attribution over an audited zoo's programs (requires
    ``audit_zoo(..., collect_costs=True)``): per-program analytic FLOPs /
    HBM / wire bytes -> roofline attribution (against the f32 or the bf16
    peak, as the program computes) with its static peak, plus the
    overlap-vs-ddp exposed-communication bound when both tiers are
    present.  Pure static analysis: no dispatch, no device."""
    from ..obs import attribution as attrlib
    if not result.costs:
        raise ValueError("audit result carries no cost reports; re-run "
                         "audit_zoo(..., collect_costs=True)")
    programs = {}
    for name, rep in result.costs.items():
        program = result.programs.get(name)
        f32 = program is None or program.contract.precision == "f32"
        programs[name] = attrlib.attribute(
            rep, mem_report=result.mem.get(name),
            peak_flops=(costmodel.H100_F32_PEAK_FLOPS if f32
                        else costmodel.H100_BF16_PEAK_FLOPS))
    out: Dict = {"programs": programs}
    ov, dd = (result.costs.get("train/window/overlap"),
              result.costs.get("train/window/ddp"))
    if ov is not None and dd is not None:
        out["overlap_vs_ddp"] = attrlib.overlap_vs_ddp(ov, dd)
    return out


def record_attribution(telemetry, attribution: Dict) -> None:
    """Attach a :func:`zoo_attribution` record to the run manifest; the
    disabled recorder path allocates and touches NOTHING."""
    if not getattr(telemetry, "enabled", False):
        return
    telemetry.update_manifest({"attribution": attribution})
