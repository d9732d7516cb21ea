"""Whole-package lock-order deadlock detector: the reference package's
``analysis/lockgraph.py``, reading the port's package.

Five threaded subsystems now interleave through six-plus class locks
(scheduler, batcher, watcher, telemetry, alerts, coordinator), and the
dangerous paths are CROSS-OBJECT: the watcher calls
``scheduler.request_install`` while holding its own lock, alert
callbacks re-enter telemetry, batch admission consults the service
model under the scheduler condition.  No test reliably provokes an
ABBA interleaving; this pass certifies its absence statically.

The analyzer builds a lock-acquisition graph over every class in the
package that owns a ``threading.Lock/RLock/Condition``:

* **nodes** are class locks, named ``ClassName.lockattr``;
* **edges** ``A -> B`` mean "somewhere, B is acquired while A is held".

Held regions are ``with self.<lock>:`` bodies, the statements following
a conditional ``self.<lock>.acquire(...)`` in the same block (the
watcher's non-blocking poll idiom), and the whole body of any
``*_locked``-suffixed method (the caller-holds contract).  Lock
effects propagate transitively: through same-class self-calls
(``observe -> _outcome -> _fire``) and through cross-object method
calls whose name resolves UNIQUELY among lock-owning classes
(``r.scheduler.request_install`` -> ``SLOScheduler``, ``tel.gauge`` ->
``Telemetry``).  Ambiguous names (``observe`` lives on both
``ServiceModel`` and ``AlertEngine``) are skipped rather than guessed —
the detector under-approximates edges, never invents them.

Verified properties, each a LintFinding on failure:

* ``lock-cycle`` — the graph must be acyclic;
* ``lock-order-violation`` / ``lock-order-undeclared`` — every edge
  must descend the declared partial order ``LOCK_ORDER`` below;
* ``lock-caller-holds`` — a ``*_locked`` method may only be called with
  its class lock held (from a held region or another ``*_locked``
  method of the same class).  This is what makes the lint's
  ``*_locked`` exemption sound: the lint trusts the suffix, this pass
  verifies every call site of the suffix;
* ``lock-cross-locked-call`` — ``*_locked`` methods are private to
  their class; calling one on another object cannot be proven held.

Known blind spots, on purpose: callbacks stored in attributes
(``Watchdog._on_timeout``) and bare-function indirection
(``predict_s=self.svc.predict`` passed as a value) are invisible —
the visible call path through ``_retry_hint_ms_locked`` pins the same
edge, and the partial order makes any hidden edge in the same
direction safe by construction.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from .pylint_rules import LintFinding, _call_name, _lock_attrs, _self_attr

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)

#: The certified partial order: an edge A -> B (B acquired while A is
#: held) is legal iff A appears STRICTLY BEFORE B here.  Outermost
#: (coarsest, longest-held) locks first; Telemetry is last because every
#: subsystem may emit telemetry from inside its own critical section and
#: telemetry must therefore never call back out while holding its lock.
LOCK_ORDER: Tuple[str, ...] = (
    "WeightWatcher._lock",        # publish poll/install; calls into sched
    "AlertEngine._lock",          # rule evaluation; emits telemetry
    "ElasticCoordinator._lock",
    "Watchdog._lock",
    "ChaosPlan._lock",
    "ReplicaRouter._lock",
    "ServingFrontend._lock",
    "FrontendClient._lock",
    "SLOScheduler._cond",         # admission; consults the service model
    "MicroBatcher._cond",         # queueing; emits telemetry
    "ServiceModel._lock",
    "Telemetry._lock",            # leaf: never calls out while held
)

_LOCK_METHODS = frozenset({"acquire", "release", "wait", "wait_for",
                           "notify", "notify_all", "locked"})
_BLOCK_FIELDS = ("body", "orelse", "finalbody")


@dataclass(frozen=True)
class CallSite:
    """One call observed inside a method, with the self-locks held."""

    held: FrozenSet[str]          # lock ATTRS of the owning class held
    recv: str                     # "self" | "other"
    name: str                     # method name called
    line: int


@dataclass
class MethodSummary:
    cls: str
    name: str
    path: str
    locks: FrozenSet[str]         # the owning class's lock attrs
    acquires: List[Tuple[FrozenSet[str], str, int]] = field(
        default_factory=list)     # (held-before, lock attr, line)
    calls: List[CallSite] = field(default_factory=list)
    locked_suffix: bool = False   # name ends with _locked

    @property
    def node_prefix(self) -> str:
        return self.cls + "."


@dataclass
class LockGraph:
    nodes: Set[str] = field(default_factory=set)
    #: (src, dst) -> evidence [(path, line, description)]
    edges: Dict[Tuple[str, str], List[Tuple[str, int, str]]] = field(
        default_factory=dict)
    findings: List[LintFinding] = field(default_factory=list)

    def add_edge(self, src: str, dst: str, path: str, line: int,
                 why: str) -> None:
        if src == dst:
            return                # RLock re-entry / same-lock nesting
        self.edges.setdefault((src, dst), []).append((path, line, why))


def _expr_calls(stmt: ast.stmt) -> Iterable[ast.Call]:
    """Call nodes in the statement's OWN expressions — not in nested
    statement blocks (those are visited with their own held set)."""
    for fname, value in ast.iter_fields(stmt):
        if fname in _BLOCK_FIELDS or fname == "handlers":
            continue
        nodes = value if isinstance(value, list) else [value]
        for n in nodes:
            if isinstance(n, ast.AST):
                for sub in ast.walk(n):
                    if isinstance(sub, ast.Call):
                        yield sub


def _summarize_method(cls: ast.ClassDef, method: ast.FunctionDef,
                      locks: Set[str], path: str) -> MethodSummary:
    summ = MethodSummary(cls=cls.name, name=method.name, path=path,
                         locks=frozenset(locks),
                         locked_suffix=method.name.endswith("_locked"))
    # A *_locked method's whole body runs with the class lock held by
    # contract; lock-caller-holds (below) verifies every call site.
    base_held = frozenset(locks) if summ.locked_suffix else frozenset()

    def visit_block(stmts: Sequence[ast.stmt], held: FrozenSet[str]) -> None:
        for stmt in stmts:
            acquired_here: Set[str] = set()
            for call in _expr_calls(stmt):
                name = _call_name(call)
                if name is None:
                    continue
                if (name in _LOCK_METHODS
                        and isinstance(call.func, ast.Attribute)):
                    attr = _self_attr(call.func.value)
                    if attr in locks and name == "acquire":
                        summ.acquires.append((held, attr, call.lineno))
                        acquired_here.add(attr)
                    continue      # wait/notify/release: not call edges
                recv = "other"
                if isinstance(call.func, ast.Attribute) and \
                        isinstance(call.func.value, ast.Name) and \
                        call.func.value.id == "self":
                    recv = "self"
                elif isinstance(call.func, ast.Name):
                    continue      # bare functions: module-level, no class
                summ.calls.append(CallSite(held, recv, name, call.lineno))
            if isinstance(stmt, ast.With):
                inner = set(held)
                for item in stmt.items:
                    attr = _self_attr(item.context_expr)
                    if attr in locks:
                        summ.acquires.append((held, attr, stmt.lineno))
                        inner.add(attr)
                visit_block(stmt.body, frozenset(inner))
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                pass              # nested defs run later, on their own terms
            else:
                for fname in _BLOCK_FIELDS:
                    sub = getattr(stmt, fname, None)
                    if sub:
                        visit_block(sub, held)
                for handler in getattr(stmt, "handlers", ()):
                    visit_block(handler.body, held)
            if acquired_here:
                # Conditional-acquire idiom: the rest of this block only
                # runs once the acquire succeeded (the failure arm
                # returns), so treat it as held from here on.
                held = frozenset(held | acquired_here)
    visit_block(method.body, base_held)
    return summ


def build_graph(sources: Dict[str, str]) -> LockGraph:
    """Build the lock graph over {path: source}."""
    graph = LockGraph()
    methods: Dict[Tuple[str, str], MethodSummary] = {}  # (cls, name) ->
    by_name: Dict[str, List[str]] = {}                  # method -> [cls]
    class_locks: Dict[str, FrozenSet[str]] = {}

    for path in sorted(sources):
        tree = ast.parse(sources[path])
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = _lock_attrs(cls)
            if not locks:
                continue
            class_locks[cls.name] = frozenset(locks)
            for lk in sorted(locks):
                graph.nodes.add(f"{cls.name}.{lk}")
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods[(cls.name, item.name)] = _summarize_method(
                        cls, item, locks, path)
                    by_name.setdefault(item.name, []).append(cls.name)

    def resolve(site: CallSite, cls: str) -> Optional[Tuple[str, str]]:
        """(class, method) a call site refers to, or None if unknown or
        ambiguous among lock-owning classes."""
        if site.recv == "self":
            return (cls, site.name) if (cls, site.name) in methods else None
        owners = by_name.get(site.name, [])
        return (owners[0], site.name) if len(owners) == 1 else None

    # -- transitive lock effects: method -> nodes it may acquire --------
    effects: Dict[Tuple[str, str], Set[str]] = {
        key: {f"{key[0]}.{lk}" for _, lk, _ in m.acquires}
        for key, m in methods.items()}
    changed = True
    while changed:
        changed = False
        for key, m in methods.items():
            acc = effects[key]
            before = len(acc)
            for site in m.calls:
                target = resolve(site, key[0])
                if target is not None:
                    acc |= effects[target]
            if len(acc) != before:
                changed = True

    # -- edges ----------------------------------------------------------
    for (cls, mname), m in methods.items():
        for held, lk, line in m.acquires:
            for h in held:
                graph.add_edge(f"{cls}.{h}", f"{cls}.{lk}", m.path, line,
                               f"{cls}.{mname} acquires self.{lk} while "
                               f"holding self.{h}")
        for site in m.calls:
            if not site.held:
                continue
            target = resolve(site, cls)
            if target is None:
                continue
            for node in sorted(effects[target]):
                for h in site.held:
                    graph.add_edge(
                        f"{cls}.{h}", node, m.path, site.line,
                        f"{cls}.{mname} calls {target[0]}.{site.name}() "
                        f"while holding self.{h}")

    # -- *_locked caller-holds verification -----------------------------
    for (cls, mname), m in methods.items():
        for site in m.calls:
            if not site.name.endswith("_locked"):
                continue
            if site.recv != "self":
                owners = by_name.get(site.name, [])
                if owners and owners != [cls]:
                    graph.findings.append(LintFinding(
                        "lock-cross-locked-call", m.path, site.line,
                        f"{cls}.{mname} calls {site.name}() on another "
                        f"object — *_locked methods are private to their "
                        f"class's critical sections"))
                continue
            if (cls, site.name) not in methods:
                continue
            if not site.held and not m.locked_suffix:
                graph.findings.append(LintFinding(
                    "lock-caller-holds", m.path, site.line,
                    f"{cls}.{mname} calls self.{site.name}() without "
                    f"holding {'/'.join(sorted(m.locks))} — the _locked "
                    f"suffix promises the caller holds the lock"))
    return graph


def check_graph(graph: LockGraph,
                order: Sequence[str] = LOCK_ORDER) -> List[LintFinding]:
    """Partial-order + acyclicity findings for a built graph."""
    findings = list(graph.findings)
    rank = {name: i for i, name in enumerate(order)}
    for (src, dst), evidence in sorted(graph.edges.items()):
        path, line, why = evidence[0]
        if src not in rank or dst not in rank:
            missing = ", ".join(n for n in (src, dst) if n not in rank)
            findings.append(LintFinding(
                "lock-order-undeclared", path, line,
                f"edge {src} -> {dst} involves lock(s) not in the "
                f"declared LOCK_ORDER ({missing}) — declare the rank "
                f"in analysis/lockgraph.py ({why})"))
        elif rank[src] >= rank[dst]:
            findings.append(LintFinding(
                "lock-order-violation", path, line,
                f"edge {src} -> {dst} ascends the declared partial "
                f"order — inverting it can deadlock against the "
                f"declared direction ({why})"))
    for cycle in _cycles(graph):
        first = graph.edges[(cycle[0], cycle[1])][0]
        findings.append(LintFinding(
            "lock-cycle", first[0], first[1],
            "lock cycle: " + " -> ".join(cycle)))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def _cycles(graph: LockGraph) -> List[List[str]]:
    """Elementary cycles via DFS (the graph has ~a dozen nodes)."""
    adj: Dict[str, List[str]] = {}
    for src, dst in graph.edges:
        adj.setdefault(src, []).append(dst)
    cycles: List[List[str]] = []
    seen_keys: Set[FrozenSet[str]] = set()

    def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
        for nxt in sorted(adj.get(node, [])):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key not in seen_keys:
                    seen_keys.add(key)
                    cycles.append(cyc)
                continue
            dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(adj):
        dfs(start, [start], {start})
    return cycles


def certified_order(graph: LockGraph,
                    order: Sequence[str] = LOCK_ORDER) -> List[str]:
    """The declared order restricted to locks that exist in the graph:
    the certified partial order."""
    return [n for n in order if n in graph.nodes]


def graph_summary(graph: LockGraph) -> dict:
    """JSON-ready description (``--verify-static``)."""
    return {
        "nodes": sorted(graph.nodes),
        "edges": [{"src": s, "dst": d, "sites": len(ev)}
                  for (s, d), ev in sorted(graph.edges.items())],
        "certified_order": certified_order(graph),
    }


def _package_sources(repo_root: str = _REPO_ROOT) -> Dict[str, str]:
    sources: Dict[str, str] = {}
    pkg = os.path.join(repo_root, "cs744_ddp_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for name in sorted(filenames):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as fh:
                    sources[path] = fh.read()
    return sources


def build_repo_graph(repo_root: str = _REPO_ROOT) -> LockGraph:
    return build_graph(_package_sources(repo_root))


def check_locks(repo_root: str = _REPO_ROOT) -> List[LintFinding]:
    """The whole-package run: [] = lock graph certified."""
    return check_graph(build_repo_graph(repo_root))


def check_source(source: str, path: str = "<source>",
                 order: Sequence[str] = LOCK_ORDER) -> List[LintFinding]:
    """Single-source entry point for fixtures/tests."""
    return check_graph(build_graph({path: source}), order)
