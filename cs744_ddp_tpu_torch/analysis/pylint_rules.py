"""AST lint for repo invariants the runtime can't see: the reference
package's ``analysis/pylint_rules.py`` (the rule engine, its waivers and
``LintFinding`` copied), with the port's vocabulary of dispatches, fences
and thread work.

Four rules, each encoding a concurrency/measurement discipline this
codebase depends on but no test can reliably catch (the failure is a
silent mis-measurement or a rare race, not an exception):

- ``unfenced-timing`` — a wall-clock interval (``t0 = time.time()`` ...
  ``time.time() - t0``) that brackets a call queueing work on the card
  (a train window's replays, an eager step, a serving dispatch:
  ``DISPATCH_NAMES``) must contain a fence (``synchronize``, ``.cpu()``,
  ``.item()``, the Trainer's ``_fetch``, the engine's ``complete``, ...:
  ``FENCE_NAMES``) between the dispatch and the interval end; otherwise
  the timer measures the enqueue, not the execution.
- ``thread-device`` — a THREAD body (any function passed as
  ``Thread(target=...)`` or to ``_prefetch_iter``) must not run eager
  device arithmetic (a ``torch.*`` call outside ``THREAD_DEVICE_OK``):
  kernels queued from a producer or a connection thread serialize
  against the main thread's replays and can deadlock under the staging
  watchdogs.  What the port's threads do by design is allowed: take
  their card (``torch.cuda.set_device``), make and use streams and
  events, allocate (``empty``, pinned host memory) and ``copy_`` on a
  side stream; the scheduler worker's graph replays are engine methods,
  not ``torch.*`` calls.
- ``lock-ownership`` — within a class owning a ``threading.Lock`` /
  ``RLock`` / ``Condition``, any attribute EVER mutated under the lock is
  lock-owned; mutating it outside a ``with <lock>:`` block (``__init__``
  excepted) is a data race.  A class can also DECLARE attributes
  lock-owned up front with a class-level ``_lock_owned = ("attr", ...)``
  tuple.  Two holding idioms are understood without waivers: a
  conditional acquire (``if not self._lock.acquire(...): return`` — the
  rest of the block runs held), and ``*_locked``-suffixed methods, whose
  whole body runs under the caller's lock by contract — the suffix is
  TRUSTED here and VERIFIED by ``analysis/lockgraph.py``, which checks
  every call site of every ``*_locked`` method actually holds the class
  lock.
- ``span-hygiene`` — a span emitted under one of the distributed-trace
  names (``trace_client``/``frontend_request``/``wire_decode``/
  ``sched_queue``/``sched_defer``/``reply_encode``) must carry the
  trace-context join keys (``**ctx.attrs()`` or an explicit
  ``trace_id=``); batch-level engine spans (``serve_stage``/
  ``serve_dispatch``/``serve_fetch``) must carry their member batcher
  trace ids (``traces=``).  A span missing its keys still renders in
  single-process reports, but the cross-process waterfall silently
  loses that stage.

Waiver: append ``# lint: ok`` to the offending line to waive every rule,
or ``# lint: ok(rule-name[, rule-name])`` to waive specific rules.  Run
standalone via ``python -m cs744_ddp_tpu_torch.analysis.lint`` (nonzero
exit on findings).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

DEFAULT_TARGETS = ("cs744_ddp_tpu_torch", "chip_smoke.py")

# Calls that queue work on the card and return before it runs: a train
# window's replays (``window(epoch, start, w)``) and a graph's ``replay``,
# an eager step (``train_step``, ``with_ok``), the forward and eval
# programs.  ``infer_counts_async`` is the serving pipeline's explicit
# issue half: timing it without its ``complete`` fence measures enqueue,
# not service.  (The engine's ``infer_counts`` and ``infer`` read their
# results back, so they fence themselves.)
DISPATCH_NAMES = frozenset({
    "window", "replay", "train_step", "with_ok", "forward_step",
    "evaluate", "infer_counts_async"})
# Calls and conversions that wait for the card: the synchronizes, a copy
# to the host (``cpu``, ``item``, ``tolist``, ``numpy``), the Trainer's
# ``_fetch`` and ``_step_fetch``, the engine's ``complete`` (it blocks
# until the dispatched replay finished), a future's ``result`` and the
# kernels' device counters (``executed_counts`` reads them back).
FENCE_NAMES = frozenset({
    "synchronize", "cpu", "item", "tolist", "numpy", "asarray", "array",
    "result", "complete", "_fetch", "_step_fetch", "executed_counts",
    "elapsed_time"})
FENCE_BUILTINS = frozenset({"float", "int", "bool"})
TIMER_ATTRS = frozenset({"time", "perf_counter", "monotonic"})
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "update", "pop",
    "popleft", "remove", "discard", "clear", "setdefault"})
LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                            "BoundedSemaphore"})
THREAD_FEEDERS = frozenset({"_prefetch_iter"})
# The ``torch.*`` calls a thread body may make (``thread-device``).
THREAD_DEVICE_OK = frozenset({
    "torch.cuda.set_device", "torch.cuda.device", "torch.cuda.stream",
    "torch.cuda.Stream", "torch.cuda.Event", "torch.cuda.current_stream",
    "torch.cuda.current_device", "torch.cuda.is_available", "torch.empty",
    "torch.empty_like", "torch.from_numpy", "torch.no_grad",
    "torch.inference_mode", "torch.is_tensor"})

_WAIVE_RE = re.compile(r"#\s*lint:\s*ok(?:\(([^)]*)\))?")


@dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str


def _waived(finding: LintFinding, source_lines: Sequence[str]) -> bool:
    if not (1 <= finding.line <= len(source_lines)):
        return False
    m = _WAIVE_RE.search(source_lines[finding.line - 1])
    if not m:
        return False
    rules = m.group(1)
    if rules is None:
        return True
    return finding.rule in {r.strip() for r in rules.split(",")}


def _call_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


# ---------------------------------------------------------------------------
# unfenced-timing
# ---------------------------------------------------------------------------

def _is_timer_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "time"
            and node.func.attr in TIMER_ATTRS)


def _check_unfenced_timing(tree: ast.AST, path: str) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        timers: Dict[str, int] = {}          # var -> start line
        elapsed: List[Tuple[str, int]] = []  # (var, line)
        dispatches: List[Tuple[str, int]] = []
        fences: List[int] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_timer_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        timers.setdefault(t.id, node.lineno)
            elif (isinstance(node, ast.BinOp)
                  and isinstance(node.op, ast.Sub)
                  and isinstance(node.right, ast.Name)
                  and _is_timer_call(node.left)):
                elapsed.append((node.right.id, node.lineno))
            elif isinstance(node, ast.Call):
                name = _call_name(node)
                if name in DISPATCH_NAMES:
                    dispatches.append((name, node.lineno))
                if name in FENCE_NAMES or name in FENCE_BUILTINS:
                    # A fence that WRAPS the dispatch starts on an earlier
                    # line; it synchronizes where it returns, so record
                    # its end line.
                    fences.append(getattr(node, "end_lineno", node.lineno))
        for var, end_line in elapsed:
            start_line = timers.get(var)
            if start_line is None or end_line <= start_line:
                continue
            for name, d_line in dispatches:
                if not (start_line < d_line <= end_line):
                    continue
                if not any(d_line <= f <= end_line for f in fences):
                    findings.append(LintFinding(
                        "unfenced-timing", path, d_line,
                        f"dispatch {name}() timed by "
                        f"{var!r} ({start_line}..{end_line}) with no "
                        f"fence (synchronize/cpu/item/_fetch/...) "
                        f"before the interval ends — the timer measures "
                        f"dispatch, not execution"))
        # A timer interval containing NO dispatch is plain host timing —
        # out of scope by construction.
    return findings


# ---------------------------------------------------------------------------
# thread-device
# ---------------------------------------------------------------------------

def _thread_entry_names(tree: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _call_name(node)
        if callee == "Thread":
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                if isinstance(kw.value, ast.Name):
                    names.add(kw.value.id)
                elif isinstance(kw.value, ast.Attribute):
                    names.add(kw.value.attr)
        elif callee in THREAD_FEEDERS:
            for arg in node.args:
                if isinstance(arg, ast.Name):
                    names.add(arg.id)
    return names


def _dotted(node: ast.AST) -> Optional[str]:
    """``torch.cuda.set_device`` for that attribute chain, None unless it
    is names and attributes all the way down."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _check_thread_device(tree: ast.AST, path: str) -> List[LintFinding]:
    entries = _thread_entry_names(tree)
    if not entries:
        return []
    findings: List[LintFinding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name not in entries:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if name is None or not name.startswith("torch.") \
                    or name in THREAD_DEVICE_OK:
                continue
            findings.append(LintFinding(
                "thread-device", path, node.lineno,
                f"{name}() inside thread entry {fn.name!r}: a thread body "
                f"must not queue device arithmetic (it serializes against "
                f"the main thread's replays); streams, events, "
                f"allocation and side-stream copies only"))
    return findings


# ---------------------------------------------------------------------------
# lock-ownership
# ---------------------------------------------------------------------------

def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Call)
                and _call_name(node.value) in LOCK_FACTORIES):
            continue
        for t in node.targets:
            attr = _self_attr(t)
            if attr:
                locks.add(attr)
    return locks


def _declared_lock_owned(cls: ast.ClassDef) -> Set[str]:
    """Attributes the class PROMISES to mutate only under its lock, via a
    class-level ``_lock_owned = ("attr", ...)`` tuple/list of string
    literals.  Non-literal elements are ignored (the declaration must be
    statically readable to mean anything here)."""
    owned: Set[str] = set()
    for stmt in cls.body:
        if not isinstance(stmt, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "_lock_owned"
                   for t in stmt.targets):
            continue
        if isinstance(stmt.value, (ast.Tuple, ast.List)):
            owned |= {el.value for el in stmt.value.elts
                      if isinstance(el, ast.Constant)
                      and isinstance(el.value, str)}
    return owned


def _attr_writes_in_stmt(stmt: ast.stmt) -> List[Tuple[str, int]]:
    """self-attribute mutations in ONE statement (not descending into
    nested statements): assignments, augmented assignments, ``del``
    of/into the attribute, and mutating method calls like
    ``self.q.append(x)``."""
    writes: List[Tuple[str, int]] = []

    def target_attr(t: ast.AST) -> Optional[str]:
        attr = _self_attr(t)
        if attr:
            return attr
        if isinstance(t, (ast.Subscript, ast.Starred)):
            return target_attr(t.value)
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                a = target_attr(el)
                if a:
                    writes.append((a, t.lineno))
        return None

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            a = target_attr(t)
            if a:
                writes.append((a, stmt.lineno))
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        a = target_attr(stmt.target)
        if a:
            writes.append((a, stmt.lineno))
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            a = target_attr(t)
            if a:
                writes.append((a, stmt.lineno))
    elif isinstance(stmt, ast.Expr):
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in MUTATOR_METHODS):
                a = _self_attr(node.func.value)
                if a:
                    writes.append((a, node.lineno))
    return writes


def _stmt_acquires(stmt: ast.stmt, locks: Set[str]) -> bool:
    """True when the statement's own expressions (not nested blocks)
    contain a ``self.<lock>.acquire(...)`` call — the conditional-acquire
    idiom: the failure arm bails out, so the REST of the enclosing block
    runs with the lock held."""
    for fname, value in ast.iter_fields(stmt):
        if fname in ("body", "orelse", "finalbody", "handlers"):
            continue
        nodes = value if isinstance(value, list) else [value]
        for n in nodes:
            if not isinstance(n, ast.AST):
                continue
            for sub in ast.walk(n):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "acquire"
                        and _self_attr(sub.func.value) in locks):
                    return True
    return False


def _collect_writes(method: ast.FunctionDef, locks: Set[str],
                    base_locked: bool = False
                    ) -> List[Tuple[str, int, bool]]:
    """(attr, line, under_lock) for every self-attribute mutation."""
    out: List[Tuple[str, int, bool]] = []

    def visit_block(stmts, locked: bool):
        for stmt in stmts:
            for attr, line in _attr_writes_in_stmt(stmt):
                out.append((attr, line, locked))
            if isinstance(stmt, ast.With):
                inner = locked or any(
                    _self_attr(item.context_expr) in locks
                    for item in stmt.items)
                visit_block(stmt.body, inner)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue   # nested defs execute later, on their own terms
            else:
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if sub:
                        visit_block(sub, locked)
                for handler in getattr(stmt, "handlers", ()):
                    visit_block(handler.body, locked)
            if not locked and _stmt_acquires(stmt, locks):
                locked = True
    visit_block(method.body, base_locked)
    return out


def _check_lock_ownership(tree: ast.AST, path: str) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        if not locks:
            continue
        per_method: Dict[str, List[Tuple[str, int, bool]]] = {}
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # *_locked methods run entirely under the caller's lock;
                # analysis/lockgraph.py verifies every call site holds it.
                per_method[item.name] = _collect_writes(
                    item, locks, base_locked=item.name.endswith("_locked"))
        owned: Set[str] = {
            attr
            for method, writes in per_method.items()
            for attr, _, locked in writes if locked}
        owned |= _declared_lock_owned(cls)
        owned -= locks   # the lock attribute itself is not guarded by itself
        for method, writes in per_method.items():
            if method == "__init__":
                continue   # construction happens-before any sharing
            for attr, line, locked in writes:
                if attr in owned and not locked:
                    findings.append(LintFinding(
                        "lock-ownership", path, line,
                        f"{cls.name}.{method} writes self.{attr} outside "
                        f"the owning lock ({'/'.join(sorted(locks))}) — "
                        f"it is mutated under the lock elsewhere, so this "
                        f"write races"))
    return findings


# ---------------------------------------------------------------------------
# span-hygiene
# ---------------------------------------------------------------------------

# The distributed-trace span vocabulary (obs/aggregate.py's contract).
# Per-request spans must carry the TraceContext join keys
# (trace_id/span_id/parent_span_id via ``**ctx.attrs()``); batch-level
# engine spans must carry the member batcher trace ids (``traces=``).
TRACED_SPAN_NAMES = frozenset({
    "trace_client", "frontend_request", "wire_decode", "sched_queue",
    "sched_defer", "reply_encode"})
BATCH_SPAN_NAMES = frozenset({"serve_stage", "serve_dispatch",
                              "serve_fetch"})


def _attrs_splat_names(fn: ast.AST) -> Set[str]:
    """Local names assigned from an ``<expr>.attrs()`` call inside this
    function — splatting one of these carries the trace context too."""
    names: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "attrs"):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _check_span_hygiene(tree: ast.AST, path: str) -> List[LintFinding]:
    """A span emitted under one of the distributed-trace names without
    its join keys is invisible to the cross-process aggregation — the
    waterfall silently loses that stage.  No test catches it (the span
    still renders in single-process reports), hence the lint."""
    findings: List[LintFinding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        attrs_vars = _attrs_splat_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _call_name(node) not in ("span", "span_event"):
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            span = node.args[0].value
            kwargs = {kw.arg for kw in node.keywords if kw.arg}
            has_ctx_splat = any(
                kw.arg is None
                and ((isinstance(kw.value, ast.Call)
                      and isinstance(kw.value.func, ast.Attribute)
                      and kw.value.func.attr == "attrs")
                     or (isinstance(kw.value, ast.Name)
                         and kw.value.id in attrs_vars))
                for kw in node.keywords)
            if span in TRACED_SPAN_NAMES \
                    and not (has_ctx_splat or "trace_id" in kwargs):
                findings.append(LintFinding(
                    "span-hygiene", path, node.lineno,
                    f"span {span!r} emitted without trace-context attrs "
                    f"(**ctx.attrs() or trace_id=...) — the cross-process "
                    f"waterfall cannot join it"))
            elif span in BATCH_SPAN_NAMES \
                    and not (has_ctx_splat or "traces" in kwargs
                             or "trace_id" in kwargs):
                findings.append(LintFinding(
                    "span-hygiene", path, node.lineno,
                    f"batch span {span!r} emitted without traces= (member "
                    f"batcher trace ids) — requests cannot be joined to "
                    f"this dispatch"))
    return findings


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

RULES = (_check_unfenced_timing, _check_thread_device,
         _check_lock_ownership, _check_span_hygiene)


def lint_source(source: str, path: str = "<source>") -> List[LintFinding]:
    tree = ast.parse(source)
    lines = source.splitlines()
    findings: List[LintFinding] = []
    for rule in RULES:
        findings.extend(rule(tree, path))
    return sorted((f for f in findings if not _waived(f, lines)),
                  key=lambda f: (f.path, f.line, f.rule))


def lint_file(path: str) -> List[LintFinding]:
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def lint_paths(paths: Sequence[str]) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        findings.extend(
                            lint_file(os.path.join(dirpath, name)))
        elif p.endswith(".py"):
            findings.extend(lint_file(p))
    return findings
