"""The port's lint entry: the AST rules of ``analysis/pylint_rules.py``
over the port's sources, and, in a path-less run, the whole-program
analyzers too: the lock-order deadlock detector (``analysis/lockgraph``:
an acyclic acquisition graph on the declared partial order, every
``*_locked`` call site holding its lock), wire-protocol schema
conformance (``analysis/wire_schema``: every struct format and TLV tag
against ``serve/wire.py``, encoder/decoder symmetry, total extension
parsing) and the memory self-checks (``analysis/memlife``: the H100
capacity single-sourced in ``analysis/costmodel.py``, the donation delta
in bytes).  Any finding exits 1.

    python -m cs744_ddp_tpu_torch.analysis.lint              # all of it
    python -m cs744_ddp_tpu_torch.analysis.lint serve ft     # these paths
    python -m cs744_ddp_tpu_torch.analysis.lint --json       # JSON findings
    python -m cs744_ddp_tpu_torch.analysis.lint --dispatch   # + the static
                                                             # dispatch
                                                             # certifier

Waive a lint line with ``# lint: ok`` or ``# lint: ok(rule-name)``; the
whole-program analyzers take no waivers — fix the source or the declared
order/schema table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from .pylint_rules import DEFAULT_TARGETS, LintFinding, lint_paths

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def dispatch_findings() -> List[LintFinding]:
    """The static round-trip certifier over a small zoo (``single`` and
    ``ddp``, meta tensors)."""
    from . import audit, dispatch
    from ..utils.metrics import WINDOW
    result = audit.audit_zoo(global_batch=64, strategies=("single", "ddp"),
                             include_eval=False)
    cert = dispatch.certify_zoo(result, window=WINDOW,
                                nbatches=WINDOW + WINDOW // 4)
    return [LintFinding(f["rule"], f["program"], 0, f["message"])
            for f in cert["findings"]]


def repo_findings(repo_root: str = REPO_ROOT) -> List[LintFinding]:
    """The path-less run: the lint over ``DEFAULT_TARGETS`` and the
    whole-program analyzers."""
    from . import lockgraph, memlife, wire_schema
    return (lint_paths([os.path.join(repo_root, t) for t in DEFAULT_TARGETS])
            + lockgraph.check_locks(repo_root)
            + wire_schema.check_wire(repo_root)
            + memlife.check_memory(repo_root))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cs744_ddp_tpu_torch.analysis.lint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: "
                         + ", ".join(DEFAULT_TARGETS)
                         + ", plus the whole-program analyzers)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON array of {rule, file, "
                         "line, message}; exit codes unchanged")
    ap.add_argument("--dispatch", action="store_true",
                    help="also run the static dispatch certifier over a "
                         "traced zoo")
    args = ap.parse_args(argv)
    findings = lint_paths(args.paths) if args.paths else repo_findings()
    if args.dispatch:
        findings += dispatch_findings()

    def rel(path: str) -> str:
        return (os.path.relpath(path, REPO_ROOT)
                if os.path.isabs(path) else path)

    if args.as_json:
        print(json.dumps([{"rule": f.rule, "file": rel(f.path),
                           "line": f.line, "message": f.message}
                          for f in findings], indent=2))
        return 1 if findings else 0
    for f in findings:
        print(f"{rel(f.path)}:{f.line}: [{f.rule}] {f.message}")
    if findings:
        print(f"{len(findings)} finding(s)")
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
