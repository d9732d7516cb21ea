"""Nothing of the benchmark loads JAX or the JAX package: in a fresh
interpreter that imports the harness, every metric file and every
plug-in, and in the sources, each module's top-level name (before the
first dot) compared whole, since the port's own name begins with the JAX
package's.  The reference and the plug-ins import nothing of the
program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cs744_ddp_tpu", "bench", "tools"}
PROGRAM = "cs744_ddp_tpu_torch"


def test_fresh_interpreter_loads_no_jax():
    code = (
        "import sys, json\n"
        "import portbench.run, portbench.calibrate, portbench.faults\n"
        "import portbench.reference.steps, portbench.plugins as p\n"
        "portbench.run.load_metrics()\n"
        "for kind in p.KINDS:\n"
        "    for f in sorted((p.ROOT / kind).glob('*.py')):\n"
        "        p.load(kind, f.stem)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert "portbench" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_sources_import_no_jax():
    found = []
    for path in sorted(ROOT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            found += [(path.name, n) for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert found == []


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and not node.level:
                assert node.module.split(".")[0] in {
                    "__future__", "typing", "numpy", "torch", "contextlib"}, \
                    (path.name, node.module)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    assert a.name.split(".")[0] in {
                        "numpy", "torch", "contextlib"}, (path.name, a.name)


def _imports(path: Path):
    """The dotted names ``path`` imports (``from a import b``: ``a.b``)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("kind", ["arch", "recipes"])
def test_plugins_import_nothing_of_the_program(kind):
    """A plug-in imports the benchmark's plain modules (the reference and
    ``data.py``), which import nothing of the program, and no more."""
    files = sorted((ROOT / kind).glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {PROGRAM}, (path.name, name)
            if top == "portbench":
                assert name.startswith(("portbench.data",
                                         "portbench.reference.")), \
                    (path.name, name)
    for name in _imports(ROOT / "data.py"):
        assert name.split(".")[0] in {"__future__", "os", "pickle", "typing",
                                      "numpy"}, name
