"""The port's source analyzers (cs744_ddp_tpu_torch/analysis/:
``pylint_rules``, ``lockgraph``, ``wire_schema``, the memory self-check and
the lint entry ``analysis/lint.py``), on the CPU.

  * (a) A seeded violation for every lint rule in the port's vocabulary
    (a train window timed without a fence, device arithmetic on a thread,
    an unlocked write, a span without its join keys), the waivers, and the
    lock-graph and wire checks' seeded faults (ABBA cycle, caller-holds,
    a cross-object ``*_locked`` call, a mismatched encoder, tag drift, a
    parser that can raise).
  * (b) The port's own tree is clean under all of them; no lock-ownership
    waiver is left in it.
  * (c) The lint entry's exit codes and its ``--json`` output.
  * (d) Oracles against the JAX package: its ``lint_source`` and the
    port's give the same findings on the reference's lock-ownership and
    span-hygiene fixture sources; its lock graph over ``cs744_ddp_tpu``
    equals the port's over ``cs744_ddp_tpu_torch``; both wire schema
    summaries are equal.
"""

import json
import os

import pytest
import torch

from cs744_ddp_tpu.analysis import lockgraph as jlockgraph
from cs744_ddp_tpu.analysis import pylint_rules as jrules
from cs744_ddp_tpu.serve import wire as jwire
from cs744_ddp_tpu_torch.analysis import (lint, lockgraph, memlife,
                                          pylint_rules, wire_schema)
from cs744_ddp_tpu_torch.serve import wire

import test_analysis as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rules(findings):
    return [f.rule for f in findings]


def _fmt(findings):
    return "\n".join(f"{f.path}:{f.line}: [{f.rule}] {f.message}"
                     for f in findings)


# -- (a) seeded violations ---------------------------------------------------

_SRC_UNFENCED = """\
import time

class T:
    def run(self, window, e):
        t0 = time.time()
        out = window(e, 0, 20)
        return time.time() - t0
"""


@pytest.mark.parametrize("fence", [
    "out = self._fetch(window(e, 0, 20))",
    "out = window(e, 0, 20).cpu()",
    "out = window(e, 0, 20); torch.cuda.synchronize()",
    "out = float(window(e, 0, 20)[0])",
])
def test_lint_unfenced_timing(fence):
    bad = pylint_rules.lint_source(_SRC_UNFENCED, "bad.py")
    assert _rules(bad) == ["unfenced-timing"] and bad[0].line == 6
    assert "window" in bad[0].message
    assert pylint_rules.lint_source(
        _SRC_UNFENCED.replace("out = window(e, 0, 20)", fence),
        "ok.py") == []
    # Plain host timing (no dispatch inside) is out of scope.
    assert pylint_rules.lint_source(
        _SRC_UNFENCED.replace("window(e, 0, 20)", "len(e)"), "ok.py") == []


def test_lint_unfenced_async_serving_dispatch():
    src = ("import time\n"
           "def serve(engine, x):\n"
           "    t0 = time.perf_counter()\n"
           "    h = engine.infer_counts_async(x)\n"
           "    return time.perf_counter() - t0\n")
    assert _rules(pylint_rules.lint_source(src, "b.py")) == \
        ["unfenced-timing"]
    fenced = src.replace("    return", "    engine.complete(h)\n    return")
    assert pylint_rules.lint_source(fenced, "ok.py") == []


_SRC_THREAD = """\
import threading
import torch

def produce(q, dev):
    torch.cuda.set_device(dev)
    buf = torch.empty(8, device=dev)
    q.put(torch.ones(3, device=dev) * 2)

def start(q, dev):
    threading.Thread(target=produce, args=(q, dev)).start()
"""


def test_lint_thread_device():
    bad = pylint_rules.lint_source(_SRC_THREAD, "bad.py")
    assert _rules(bad) == ["thread-device"] and bad[0].line == 7
    assert "torch.ones" in bad[0].message
    ok = _SRC_THREAD.replace("torch.ones(3, device=dev) * 2", "buf")
    assert pylint_rules.lint_source(ok, "ok.py") == []
    # The same call outside any thread entry is fine.
    no_thread = _SRC_THREAD.replace(
        "threading.Thread(target=produce, args=(q, dev)).start()",
        "produce(q, dev)")
    assert pylint_rules.lint_source(no_thread, "ok.py") == []
    # A _prefetch_iter feeder is a thread entry too.
    feeder = _SRC_THREAD.replace(
        "threading.Thread(target=produce, args=(q, dev)).start()",
        "self._prefetch_iter(produce)")
    assert _rules(pylint_rules.lint_source(feeder, "b.py")) == \
        ["thread-device"]


def test_lint_lock_ownership_and_waivers():
    bad = pylint_rules.lint_source(ref._SRC_UNLOCKED, "bad.py")
    assert _rules(bad) == ["lock-ownership"] and bad[0].line == 13
    drain = "    def drain(self):\n        self._items = []"
    for waiver, kept in (("# lint: ok(lock-ownership)", []),
                         ("# lint: ok", []),
                         ("# lint: ok(thread-device)", ["lock-ownership"])):
        src = ref._SRC_UNLOCKED.replace(drain, f"{drain}   {waiver}")
        assert _rules(pylint_rules.lint_source(src, "w.py")) == kept


def test_lint_span_hygiene():
    bad = pylint_rules.lint_source(ref._SRC_SPAN_BARE, "bad.py")
    assert _rules(bad) == ["span-hygiene"]
    assert pylint_rules.lint_source(ref._SRC_SPAN_SPLAT, "ok.py") == []
    batch = ("def emit(tel, t0):\n"
             "    tel.span_event('serve_dispatch', t0, 0.01, bucket=8)\n")
    assert _rules(pylint_rules.lint_source(batch, "b.py")) == \
        ["span-hygiene"]


def test_lockgraph_seeded_faults():
    finds = lockgraph.check_source(ref._SRC_ABBA, "abba.py",
                                   order=("A._lock", "B._lock"))
    assert {"lock-cycle", "lock-order-violation"} <= set(_rules(finds))
    acyclic = ref._SRC_ABBA.replace("            self.peer.poked()",
                                    "            pass")
    assert lockgraph.check_source(acyclic, "ok.py",
                                  order=("A._lock", "B._lock")) == []
    finds = lockgraph.check_source(ref._SRC_CALLER_HOLDS, "w.py", order=())
    assert _rules(finds) == ["lock-caller-holds"]
    assert "bad" in finds[0].message
    cross = ref._SRC_CALLER_HOLDS.replace(
        "    def bad(self):\n        self._drain_locked()",
        "    def bad(self):\n        pass") + (
        "\nclass Z:\n    def __init__(self, w):\n"
        "        self._lock = threading.Lock()\n        self.w = w\n\n"
        "    def steal(self):\n        self.w._drain_locked()\n")
    assert _rules(lockgraph.check_source(cross, "z.py", order=())) == \
        ["lock-cross-locked-call"]


def test_wire_seeded_faults():
    finds = wire_schema.check_source(ref._SRC_BAD_ENCODER, "bad.py")
    assert _rules(finds) == ["wire-format-mismatch"]
    drift = ("import struct\n_EXTRA = struct.Struct('<Q')\n"
             "TAG_TRACE = 9\nTAG_NEW = 9\n")
    rules = set(_rules(wire_schema.check_source(drift, "drift.py")))
    assert rules == {"wire-unregistered-format", "wire-tag-mismatch",
                     "wire-unregistered-tag", "wire-tag-dup"}
    raising = ("def unpack_ext(buf):\n"
               "    if not buf:\n        raise ValueError('empty')\n"
               "    return _TLV.unpack_from(buf, 0)\n")
    assert set(_rules(wire_schema.check_ext_parser_total(raising, "p.py"))) \
        == {"wire-ext-raise", "wire-ext-unguarded"}
    # The live parser survives every truncation and byte flip.
    assert wire_schema.ext_parse_corruption_sweep() == []


def test_memory_self_check_donation_delta():
    inplace, rebind = memlife.donation_delta()
    leaf = 64 * 32 * 4
    assert (inplace.rebound_bytes, rebind.rebound_bytes) == (0, leaf)
    assert rebind.peak_bytes - inplace.peak_bytes == leaf
    assert memlife.check_donation_delta() == []


def test_memory_constant_single_sourced(tmp_path):
    assert memlife.check_constants_single_source(REPO) == []
    pkg = tmp_path / "cs744_ddp_tpu_torch" / "analysis"
    pkg.mkdir(parents=True)
    (pkg / "costmodel.py").write_text("H100_HBM_CAPACITY_BYTES = 1\n")
    (tmp_path / "chip_smoke.py").write_text("H100_HBM_CAPACITY_BYTES = 2\n")
    finds = memlife.check_constants_single_source(str(tmp_path))
    assert _rules(finds) == ["memory-constants"]
    assert finds[0].path.endswith("chip_smoke.py")


# -- (b) the port's tree is clean ----------------------------------------------

def test_repo_is_clean_under_every_analyzer():
    finds = lint.repo_findings(REPO)
    assert finds == [], _fmt(finds)
    graph = lockgraph.build_repo_graph(REPO)
    # The analyzer sees the cross-object edges the threads take.
    for edge in (("WeightWatcher._lock", "SLOScheduler._cond"),
                 ("AlertEngine._lock", "Telemetry._lock"),
                 ("SLOScheduler._cond", "ServiceModel._lock")):
        assert edge in graph.edges
    assert wire.verify_runtime() == []


def test_no_lock_ownership_waivers_left():
    hits = []
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(REPO, "cs744_ddp_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    if "lint: ok(lock-ownership)" in f.read():
                        hits.append(name)
    assert hits == []


# -- (c) the lint entry ----------------------------------------------------------

def test_lint_entry_exit_codes_and_json(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(ref._SRC_UNLOCKED)
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    assert lint.main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "[lock-ownership]" in out and "1 finding(s)" in out
    assert lint.main([str(ok)]) == 0
    assert "lint: clean" in capsys.readouterr().out
    assert lint.main(["--json", str(bad)]) == 1
    (f,) = json.loads(capsys.readouterr().out)
    assert set(f) == {"rule", "file", "line", "message"}
    assert (f["rule"], f["line"]) == ("lock-ownership", 13)
    assert lint.main(["--json", str(ok)]) == 0
    assert json.loads(capsys.readouterr().out) == []


def test_lint_entry_dispatch_certificate():
    assert lint.dispatch_findings() == []


# -- (d) oracles against the JAX package ---------------------------------------

@pytest.mark.parametrize("name", [
    "_SRC_UNLOCKED", "_SRC_DECLARED", "_SRC_ROUTER", "_SRC_CONDACQ",
    "_SRC_LOCKED_SUFFIX", "_SRC_SPAN_BARE", "_SRC_SPAN_SPLAT"])
def test_lint_source_equals_the_reference(name):
    src = getattr(ref, name)
    variants = [src]
    if name == "_SRC_LOCKED_SUFFIX":
        variants.append(src.replace("_reset_locked", "_reset"))
    if name == "_SRC_CONDACQ":
        variants.append(src.replace(
            "        if not self._lock.acquire(blocking=False):",
            "        self.n += 1\n"
            "        if not self._lock.acquire(blocking=False):"))
    for s in variants:
        mine = pylint_rules.lint_source(s, "f.py")
        theirs = jrules.lint_source(s, "f.py")
        assert [(f.rule, f.line, f.message) for f in mine] == \
            [(f.rule, f.line, f.message) for f in theirs]


def test_lock_graph_equals_the_reference():
    """The same 12 locks, edges and certified order over the two
    packages (node names carry no package prefix; the call sites behind
    each edge are counted alike)."""
    mine = lockgraph.graph_summary(lockgraph.build_repo_graph(REPO))
    theirs = jlockgraph.graph_summary(jlockgraph.build_repo_graph(REPO))
    assert mine == theirs
    assert len(mine["nodes"]) == 12 and len(mine["edges"]) == 5
    assert lockgraph.LOCK_ORDER == jlockgraph.LOCK_ORDER


def test_wire_schema_equals_the_reference():
    assert wire.schema_summary() == jwire.schema_summary()
    assert wire_schema.check_wire(REPO) == []
