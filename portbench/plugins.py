"""The benchmark's extension points, each a Python file found by name
under a root (``portbench/`` itself, or the root that ``run.load_cell``
was given), so that a new architecture or a new kind of training data is
new files only.

``arch/<architecture>.py``, named by a configuration's ``architecture``:

  * ``leaves(config)``: every parameter as a ``reference.layers.Leaf``, in
    the order the program's module registers them;
  * ``init(config, seed, device)``: (parameters, state), f32 on
    ``device``, the parameters drawn from ``seed`` as the program draws
    them, the state the non-parameter tensors that ``forward`` updates;
  * ``forward(config, params, state, x, q)``: the logits ``[rows,
    classes]`` of the reference's inputs ``x`` in training mode, updating
    its own copies ``state``; ``q`` rounds what a mixed-precision program
    stores in its activation dtype (the identity in f32);
  * ``macs_per_example(config, traffic)``: multiply-accumulates of one
    example's forward pass (the yardstick's FLOPs are 6 x these);
  * ``BATCH_STATISTICS``: whether a forward's result for one row depends
    on the other rows of its batch (BatchNorm in training mode);
  * optional ``CHECKED_STATE``: the suffixes of the program's buffer names
    whose change after the first step is compared (``stats1_gap``), in
    the order of ``init``'s state, which is that state; none if absent;
  * optional ``pool_blocks(config)``: (channels, height, width) before
    each fused BN -> ReLU -> MaxPool block of the program, for the
    yardstick's byte count; none if absent;
  * optional ``PROGRAM_KEYS``: the program's ``Trainer`` keywords of this
    model that a traffic's ``program`` object may give
    (``worker.program_keywords``).

``recipes/<recipe>.py``, named by a traffic's ``dataset.recipe``:

  * ``make(dataset, seed, data_dir, device)``: makes the split from
    ``seed`` and writes it under ``data_dir`` in the files the program's
    ``Trainer`` reads from its ``data_dir``;
  * ``examples(dataset)``: the examples an epoch of the split holds (what
    ``train_images_per_s`` counts; the run refuses a program that trains
    another number of steps an epoch);
  * ``read(data_dir)``: the split back from those files, for the
    reference;
  * ``batch(split, rows, traffic, seed, rank, step, device)``: the
    reference's ``(x, y)`` for ``rows`` of the split, step ``step`` of
    epoch 0 on rank ``rank``; ``y`` holds one class index a row of the
    logits.

A plug-in imports nothing of the program: only NumPy, PyTorch and the
benchmark's plain modules (``reference/``, ``data.py``).
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, Tuple

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KINDS = ("arch", "recipes")

_LOADED: Dict[Path, ModuleType] = {}


def exec_file(path: Path, module_name: str) -> ModuleType:
    """The module that the Python file ``path`` makes, under
    ``module_name`` (not entered in ``sys.modules``)."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The plug-in ``root/<kind>/<name>.py``, loaded once a process."""
    if kind not in KINDS:
        raise ValueError(f"not a kind of plug-in: {kind!r}")
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = (Path(root) / kind / f"{name}.py").resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise ValueError(f"no {kind} plug-in {name!r}: {path} is not a "
                             f"file")
        _LOADED[path] = exec_file(
            path, f"portbench_{kind}_{name.replace('.', '_')}_{len(_LOADED)}")
    return _LOADED[path]


def architecture(config: dict, root: Path = ROOT) -> ModuleType:
    return load("arch", config["architecture"], root)


def cell(spec: dict) -> Tuple[ModuleType, ModuleType]:
    """(architecture, recipe) of ``spec``, a cell as ``run.load_cell``
    gives it."""
    return (architecture(spec["config"], spec["root"]),
            load("recipes", spec["traffic"]["dataset"]["recipe"],
                 spec["root"]))
