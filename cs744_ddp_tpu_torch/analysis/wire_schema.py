"""Static wire-protocol schema conformance: the reference package's
``analysis/wire_schema.py``, over the port's codec sources.

``serve/wire.py`` is the single declarative description of the serving
wire protocol.  This module verifies — WITHOUT importing the codec —
that the codec sources actually implement that table:

* every ``struct.Struct("...")`` assignment and every direct
  ``struct.pack/unpack`` format literal in the covered modules resolves
  to a registered format (an unregistered format is protocol drift the
  table never reviewed);
* a registered constant name bound to a DIFFERENT format than the table
  declares is a mismatch (the deliberately-broken-encoder fixture);
* encoder/decoder symmetry: each registered struct is used by at least
  one ``pack`` and one ``unpack`` site across the covered modules —
  a format that is only ever packed (or only unpacked) is a frame one
  peer can emit and no peer can read;
* TLV tag uniqueness and table agreement for every ``TAG_*`` constant;
* the optional-extension parser can never raise: ``unpack_ext`` carries
  no ``raise`` and every ``unpack_from`` inside it sits behind a length
  guard (checked on the AST), and an exhaustive deterministic corruption
  sweep over truncations/byte-flips of a canonical block confirms it
  (checked on the live function).

Findings reuse the lint's ``LintFinding`` shape so the lint entry
(``analysis/lint.py``) prints/serializes them uniformly.  Covered
modules: ``serve/frontend.py``, ``obs/tracing.py``, ``serve/load.py``
(the third must simply contain no wire sites — clients go through
``FrontendClient``, never raw structs).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from ..serve import wire
from .pylint_rules import LintFinding

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)

# Modules the schema must cover (repo-relative).  Everything that packs
# or parses wire bytes lives here; a new module touching the wire must
# be added, or its formats show up as uncovered in the repo scan below.
COVERED = (
    os.path.join("cs744_ddp_tpu_torch", "serve", "frontend.py"),
    os.path.join("cs744_ddp_tpu_torch", "obs", "tracing.py"),
    os.path.join("cs744_ddp_tpu_torch", "serve", "load.py"),
)

_PACK_METHODS = frozenset({"pack", "pack_into"})
_UNPACK_METHODS = frozenset({"unpack", "unpack_from", "iter_unpack"})


def _is_struct_ctor(node: ast.AST) -> Optional[str]:
    """``struct.Struct("<fmt>")`` -> the literal format, else None."""
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "Struct"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "struct"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        return node.args[0].value
    return None


def extract_struct_defs(tree: ast.AST) -> Dict[str, Tuple[str, int]]:
    """Module-level ``NAME = struct.Struct("...")`` -> {name: (fmt, line)}."""
    defs: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        fmt = _is_struct_ctor(node.value)
        if fmt is None:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                defs[t.id] = (fmt, node.lineno)
    return defs


def extract_direct_sites(tree: ast.AST) -> List[Tuple[str, int]]:
    """Direct ``struct.pack("<fmt>", ...)`` / ``struct.unpack(...)`` call
    sites with a literal format -> [(fmt, line)].  These bypass the named
    registry, so each format must still be registered."""
    sites: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in (_PACK_METHODS | _UNPACK_METHODS
                                       | {"calcsize"})
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "struct"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            sites.append((node.args[0].value, node.lineno))
    return sites


def extract_tags(tree: ast.AST) -> Dict[str, Tuple[int, int]]:
    """Module-level ``TAG_* = <int>`` -> {name: (value, line)}."""
    tags: Dict[str, Tuple[int, int]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id.startswith("TAG_"):
                tags[t.id] = (node.value.value, node.lineno)
    return tags


def extract_uses(tree: ast.AST) -> Dict[str, Set[str]]:
    """``NAME.pack(...)`` / ``NAME.unpack_from(...)`` -> {name: {"pack",
    "unpack"}} across the module (the symmetry evidence)."""
    uses: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)):
            continue
        name = node.func.value.id
        if node.func.attr in _PACK_METHODS:
            uses.setdefault(name, set()).add("pack")
        elif node.func.attr in _UNPACK_METHODS:
            uses.setdefault(name, set()).add("unpack")
    return uses


def check_source(source: str, path: str = "<source>",
                 *, registered: Optional[Dict[str, str]] = None,
                 tags: Optional[Dict[str, int]] = None
                 ) -> List[LintFinding]:
    """Formats/tags of ONE module against the schema registry."""
    registered = wire.REGISTERED_FORMATS if registered is None else registered
    tags = wire.REGISTERED_TAGS if tags is None else tags
    tree = ast.parse(source)
    findings: List[LintFinding] = []
    known_fmts = set(registered.values())

    for name, (fmt, line) in sorted(extract_struct_defs(tree).items()):
        want = registered.get(name)
        if want is None:
            findings.append(LintFinding(
                "wire-unregistered-format", path, line,
                f"struct {name} = Struct({fmt!r}) is not registered in "
                f"serve/wire.py — every wire format must live in the "
                f"schema table"))
        elif fmt != want:
            findings.append(LintFinding(
                "wire-format-mismatch", path, line,
                f"struct {name} packs {fmt!r} but serve/wire.py declares "
                f"{want!r} — encoder and schema have drifted"))
    for fmt, line in extract_direct_sites(tree):
        if fmt not in known_fmts:
            findings.append(LintFinding(
                "wire-unregistered-format", path, line,
                f"direct struct call with unregistered format {fmt!r}"))

    seen_tag_values: Dict[int, str] = {}
    for name, (value, line) in sorted(extract_tags(tree).items()):
        prev = seen_tag_values.get(value)
        if prev is not None:
            findings.append(LintFinding(
                "wire-tag-dup", path, line,
                f"{name} reuses TLV tag {value} already taken by {prev} — "
                f"tags must be unique for unknown-tag skipping to work"))
        seen_tag_values[value] = name
        want = tags.get(name)
        if want is None:
            findings.append(LintFinding(
                "wire-unregistered-tag", path, line,
                f"{name} = {value} is not registered in serve/wire.py"))
        elif value != want:
            findings.append(LintFinding(
                "wire-tag-mismatch", path, line,
                f"{name} = {value} but serve/wire.py declares {want}"))
    return findings


def check_ext_parser_total(source: str, path: str) -> List[LintFinding]:
    """``unpack_ext`` must be TOTAL: no ``raise``, and every
    ``unpack_from`` inside it lexically behind a ``len(...)`` bound
    comparison — the extension block is optional forward-compat data, so
    a torn/alien block must degrade to {} rather than kill a frame."""
    tree = ast.parse(source)
    findings: List[LintFinding] = []
    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name == "unpack_ext"):
            continue
        guards = 0
        unpacks = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Raise):
                findings.append(LintFinding(
                    "wire-ext-raise", path, node.lineno,
                    "unpack_ext raises — optional-extension parsing must "
                    "degrade to {}, never fail a frame"))
            elif isinstance(node, ast.Compare):
                if any(isinstance(n, ast.Call)
                       and isinstance(n.func, ast.Name)
                       and n.func.id == "len"
                       for n in ast.walk(node)):
                    guards += 1
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in _UNPACK_METHODS):
                unpacks.append(node.lineno)
        if len(unpacks) > guards:
            findings.append(LintFinding(
                "wire-ext-unguarded", path, unpacks[0],
                f"unpack_ext has {len(unpacks)} unpack site(s) but only "
                f"{guards} len() bound check(s) — a short buffer can "
                f"raise out of the optional-extension parser"))
    return findings


def ext_parse_corruption_sweep() -> List[str]:
    """Exhaustive deterministic corruption sweep over the LIVE
    ``unpack_ext``: every truncation of a canonical two-field block, and
    every byte value at every offset.  Returns failure descriptions
    ([] = the parser is total on this corpus)."""
    from ..obs import tracing

    base = tracing.pack_ext({
        wire.REGISTERED_TAGS["TAG_TRACE"]: b"\x01" * 24 + b"origin",
        wire.REGISTERED_TAGS["TAG_SERVER_TIMES"]: b"\x02" * 16,
        0x7F: b"future-field",       # unknown tag: must be skipped
    })
    failures: List[str] = []

    def feed(buf: bytes, what: str) -> None:
        try:
            out = tracing.unpack_ext(buf)
        except Exception as e:       # noqa: BLE001 - the property under test
            failures.append(f"unpack_ext raised {type(e).__name__} on "
                            f"{what}: {e}")
            return
        if not isinstance(out, dict):
            failures.append(f"unpack_ext returned {type(out).__name__} "
                            f"on {what}")

    for cut in range(len(base) + 1):
        feed(base[:cut], f"truncation at {cut}")
    for off in range(len(base)):
        for val in range(256):
            if base[off] == val:
                continue
            feed(base[:off] + bytes([val]) + base[off + 1:],
                 f"byte {off} -> {val}")
    return failures


def _relpath(path: str) -> str:
    return os.path.relpath(path, _REPO_ROOT)


def check_wire(repo_root: str = _REPO_ROOT) -> List[LintFinding]:
    """The full conformance run over the covered modules + the live
    codec.  [] = the wire protocol, its schema table, and its parsers
    agree; anything else is a finding with a file/line to fix."""
    findings: List[LintFinding] = []
    all_uses: Dict[str, Set[str]] = {}
    defined: Set[str] = set()
    for rel in COVERED:
        path = os.path.join(repo_root, rel)
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        findings.extend(check_source(source, path))
        tree = ast.parse(source)
        defined |= set(extract_struct_defs(tree))
        for name, kinds in extract_uses(tree).items():
            all_uses.setdefault(name, set()).update(kinds)
    # Symmetry: every registered struct must be defined somewhere covered
    # and used by BOTH a pack and an unpack site across the modules.
    for name in sorted(wire.REGISTERED_FORMATS):
        if name not in defined:
            findings.append(LintFinding(
                "wire-missing-struct", COVERED[0], 0,
                f"registered struct {name} is defined in no covered "
                f"module — schema table and codec have diverged"))
            continue
        kinds = all_uses.get(name, set())
        for want in ("pack", "unpack"):
            if want not in kinds:
                findings.append(LintFinding(
                    "wire-asymmetric", COVERED[0], 0,
                    f"struct {name} has no {want} site in any covered "
                    f"module — one peer direction cannot speak it"))
    tracing_path = os.path.join(repo_root, COVERED[1])
    with open(tracing_path, encoding="utf-8") as fh:
        findings.extend(check_ext_parser_total(fh.read(), tracing_path))
    for problem in wire.verify_runtime():
        findings.append(LintFinding(
            "wire-table-drift", os.path.join(repo_root,
                                             "cs744_ddp_tpu_torch", "serve",
                                             "wire.py"), 0,
            problem))
    for failure in ext_parse_corruption_sweep():
        findings.append(LintFinding(
            "wire-ext-raise", tracing_path, 0, failure))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
