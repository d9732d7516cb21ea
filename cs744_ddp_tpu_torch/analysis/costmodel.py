"""Analytic FLOPs/bytes cost model of the port: the counterpart of the
reference package's ``analysis/costmodel.py``, over the aten operators that
one call of a function dispatches instead of the instructions of an HLO
module.

How it counts: ``count(fn, *args)`` calls ``fn`` once under a
``TorchDispatchMode`` with every tensor on the ``meta`` device
(``meta_model`` puts a zoo model there), so each operator is seen with its
shapes and dtypes and none computes: VGG-11's whole train step at batch 256
costs no arithmetic, and nothing is counted at a small batch and scaled.

Charging, per operator (the reference's rules):

- **convolution** at ``2 x result_elems x kernel_elems / C_out``; its
  backward the same per gradient it produces (input and weight; the bias
  gradient is a reduction over dy);
- **mm / addmm / bmm / linear** at ``2 x result_elems x K`` (the bias add
  of addmm and linear is elementwise);
- **elementwise** (aten's pointwise operators, a cast between dtypes, the
  ``_foreach_`` family) at one flop per result element;
- **reductions** at one flop per input element;
- **fused operators** (batch norm and its backward, softmax, logsumexp) as
  the passes over their input that they fuse (``_FUSED``);
- **data movement** (views, copies, cat, gather, index, pad, fills) at 0;
- **HBM bytes**: operand plus result bytes of every operator but the views
  and the allocations (``_FREE``): "nothing fuses"; a destination that is
  only written (``copy_``, ``fill_``, ``zero_``, an ``out=`` tensor) is
  charged once, as a result, so a copy costs its tensor twice, as the
  reference's copy does;
- the **bnpool kernels** (``ops/bnpool.py``), one operator each on meta
  tensors, at 0 flops and their operands' and results' bytes, as the
  reference charges its Pallas custom call; the plain version's arithmetic
  is never counted.

**Wire bytes** are the collectives the ``CountingGroup`` that the counted
step was built with records, by result bytes as ``parallel.mesh.Group``
counts them (the strategy's and the mean of the BN statistics and the loss
over the ranks); 0 at world 1, where nothing crosses a wire.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models import get_model
from ..ops import bnpool
from ..parallel.mesh import Collective, Group, _Waited

# NVIDIA's H100 SXM5 datasheet figures, per card (dense, no sparsity).
H100_BF16_PEAK_FLOPS = 989.4e12      # bf16 on the tensor cores
# f32 on the CUDA cores: the port trains f32 with TF32 off
# (``device.py::set_f32_parity``).
H100_F32_PEAK_FLOPS = 66.9e12
H100_HBM_BYTES_PER_S = 3.35e12       # HBM3 bandwidth
H100_HBM_CAPACITY_BYTES = 80 * 10 ** 9
H100_NVLINK_BYTES_PER_S = 450e9      # NVLink 4: 900 GB/s, 450 a direction

_DOTS = frozenset(("mm", "addmm", "bmm", "baddbmm", "mv", "addmv",
                   "linear"))
_REDUCE = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "var", "std", "var_mean", "std_mean", "norm",
    "linalg_vector_norm", "_foreach_norm", "all", "any", "count_nonzero",
    "cumsum", "nansum", "max_pool2d_with_indices", "avg_pool2d",
    "_adaptive_avg_pool2d", "nll_loss_forward"))
# Fused operators: (reduction passes, elementwise passes) over the elements
# of their first operand -- the primitives that the reference's lowering
# spells out.  Train-mode batch norm: the mean and variance passes, then
# subtract, scale, and the affine multiply and add; its backward: the sums
# of dy and dy*xhat, then the five-term input gradient.
_FUSED = {
    "native_batch_norm": (2, 4), "_native_batch_norm_legit": (2, 4),
    "_native_batch_norm_legit_no_training": (0, 4),
    "_native_batch_norm_legit_functional": (2, 4),
    "native_batch_norm_backward": (2, 5),
    "_log_softmax": (2, 3), "_softmax": (2, 3),
    "_log_softmax_backward_data": (1, 3), "_softmax_backward_data": (1, 3),
    "logsumexp": (2, 2),
}
# Operators that move no bytes of their own: allocations and aliases (the
# views are found by their schemas).
_FREE = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "detach", "alias", "_unsafe_view",
                   "lift_fresh", "_reshape_alias"))
_CASTS = frozenset(("_to_copy", "copy_"))
# Operators that overwrite their first operand without reading it: its
# bytes are charged once, as the result's.
_OVERWRITE = frozenset(("copy_", "fill_", "zero_"))


def mfu_fields(ips_per_chip: float, flops_per_image: Optional[float],
               peak_flops: float = H100_BF16_PEAK_FLOPS) -> Dict:
    """Achieved TFLOP/s and model-flops utilization for a measured per-card
    image rate, against the H100's bf16 peak.  Returns ``{}`` when the
    analytic flop count is unavailable: absent keys, never null values."""
    if not flops_per_image:
        return {}
    tflops = ips_per_chip * flops_per_image / 1e12
    return {
        "tflops_per_sec": round(tflops, 2),
        "mfu_vs_bf16_peak": round(tflops * 1e12 / peak_flops, 4),
    }


@dataclass
class CostReport:
    """Analytic costs of one call of a program, on one rank.

    ``trip_counts`` stays empty: the port has no loop in a counted program,
    since a window is that many replays of one captured step, whose cost
    is the step's times its steps."""
    name: str
    flops: float = 0.0
    flops_by_op: Dict[str, float] = field(default_factory=dict)
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    wire_by_collective: Dict[str, int] = field(default_factory=dict)
    collective_sizes: List[int] = field(default_factory=list)  # per op
    trip_counts: Dict[str, int] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    @property
    def arithmetic_intensity(self) -> float:
        """flops / HBM byte: the roofline x-axis."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else math.inf

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "gflops": round(self.flops / 1e9, 4),
            "flops_by_op": {k: round(v / 1e9, 4)
                            for k, v in self.flops_by_op.items()},
            "hbm_mib": round(self.hbm_bytes / 2**20, 3),
            "wire_mib": round(self.wire_bytes / 2**20, 4),
            "wire_by_collective": dict(self.wire_by_collective),
            "collective_sizes": list(self.collective_sizes),
            "trip_counts": dict(self.trip_counts),
            "arithmetic_intensity": (
                round(self.arithmetic_intensity, 2)
                if self.hbm_bytes else None),
            "notes": list(self.notes),
        }


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _elems(x) -> int:
    return sum(t.numel() for t in _tensors(x))


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _flops(name: str, func, args, out) -> Dict[str, float]:
    """The flops one operator is charged, by kind."""
    if name == "convolution":
        weight = args[1]
        if args[6]:                       # transposed: [C_in, C_out/g, ..]
            c_out = weight.shape[1] * args[8]
        else:
            c_out = weight.shape[0]
        return {"convolution": 2.0 * out.numel() * weight.numel() / c_out}
    if name == "convolution_backward":
        grad_out, weight, mask = args[0], args[2], args[10]
        per = 2.0 * grad_out.numel() * weight.numel() / weight.shape[0]
        got = {"convolution": per * (int(mask[0]) + int(mask[1]))}
        if mask[2]:
            got["reduce"] = float(grad_out.numel())
        return got
    if name in _DOTS:
        lhs = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
        got = {"dot": 2.0 * out.numel() * lhs.shape[-1]}
        if name in ("addmm", "baddbmm", "addmv") or (
                name == "linear" and len(args) > 2 and args[2] is not None):
            got["elementwise"] = float(out.numel())
        return got
    if name in _FUSED:
        passes_r, passes_e = _FUSED[name]
        n = float(args[0].numel())
        if name == "native_batch_norm" and not args[5]:   # eval mode
            passes_r = 0
        return {"reduce": passes_r * n, "elementwise": passes_e * n}
    if name in _REDUCE:
        return {"reduce": float(_elems(args[0]))}
    if name.startswith("_foreach_"):
        return {"elementwise": float(_elems(args[0]))}
    if torch.Tag.pointwise in func.tags:
        return {"elementwise": float(_elems(out))}
    if name in _CASTS:
        src = args[0] if name == "_to_copy" else args[1]
        if isinstance(src, torch.Tensor) and src.dtype != out.dtype:
            return {"elementwise": float(out.numel())}
    return {}


class _Counter(TorchDispatchMode):
    """Charges every operator dispatched while it is active to ``report``."""

    def __init__(self, report: CostReport):
        super().__init__()
        self.report = report

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rep = self.report
        name = func.overloadpacket.__name__
        if func.namespace != bnpool.META_NAMESPACE:
            for kind, fl in _flops(name, func, args, out).items():
                if fl:
                    rep.flops += fl
                    rep.flops_by_op[kind] = rep.flops_by_op.get(kind, 0.0) \
                        + fl
        if not func.is_view and name not in _FREE:
            # An ``out=`` tensor, like an overwritten operand, is written
            # and not read; an in-place update (``add_``) reads and writes.
            reads = (args[1:] if name in _OVERWRITE else args,
                     {k: v for k, v in kwargs.items() if k != "out"})
            rep.hbm_bytes += _nbytes(reads) + _nbytes(out)
        return out


class CountingGroup(Group):
    """``parallel.mesh.Group`` for a counted step: the collectives of rank
    ``rank`` of ``world`` are counted and linked as ``Group`` counts and
    links them (``step_links``), and also recorded one by one, the
    uncounted rank mean included, for as long as the group lives
    (``issued``: each ``Collective`` with what ``clock()`` returned as it
    was issued, when a caller set it); none sends anything, and none
    needs a process group."""

    def __init__(self, world: int, rank: int = 0):
        # No Group.__init__: it reads the process group.
        self.world, self.rank = int(world), int(rank)
        self.step_counts: Counter = Counter()
        self.total_counts: Counter = Counter()
        self.step_bytes: Counter = Counter()
        self.total_bytes: Counter = Counter()
        self.issued: List[Tuple[Collective, int]] = []
        self.clock: Optional[Callable[[], int]] = None
        self.reset_step()

    def _record(self, kind: str, nbytes: int, counted: bool,
                async_op: bool = False) -> None:
        super()._record(kind, nbytes, counted, async_op)
        self.issued.append((self.step_links[-1],
                            self.clock() if self.clock else -1))

    def all_reduce(self, t: torch.Tensor, async_op: bool = False):
        self._count("all_reduce", _nbytes(t), async_op)
        return _Waited(None, self) if async_op else None

    def all_reduce_max(self, t: torch.Tensor) -> None:
        self._count("all_reduce_max", _nbytes(t))

    def gather(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        self._count("gather", self.world * _nbytes(t))
        return [torch.empty_like(t) for _ in range(self.world)] \
            if self.rank == 0 else None

    def scatter(self, out: torch.Tensor, chunks) -> None:
        self._count("scatter", _nbytes(out))

    def all_gather(self, out: torch.Tensor, t: torch.Tensor) -> None:
        self._count("all_gather", _nbytes(out))

    def all_reduce_uncounted(self, t: torch.Tensor) -> None:
        self._record("all_reduce", _nbytes(t), False)


def meta_model(name: str, seed: int = 0) -> torch.nn.Module:
    """Zoo model ``name`` on the meta device, channels_last, as the
    Trainer and the serving engine lay theirs out."""
    return get_model(name, seed).to("meta",
                                    memory_format=torch.channels_last)


def count(fn: Callable, *args, name: str = "program",
          group: Optional[CountingGroup] = None, **kwargs) -> CostReport:
    """The ``CostReport`` of one call ``fn(*args, **kwargs)`` on meta
    tensors; ``group`` is the ``CountingGroup`` ``fn`` was built with, if
    any.  An operator with no meta implementation raises
    ``NotImplementedError``."""
    rep = CostReport(name=name)
    start = len(group.issued) if group is not None else 0
    with _Counter(rep):
        fn(*args, **kwargs)
    if group is not None and group.world > 1:
        issued = [c for c, _ in group.issued[start:]]
        rep.collective_sizes = [c.nbytes for c in issued]
        rep.wire_bytes = float(sum(rep.collective_sizes))
        wire: Counter = Counter()
        for c in issued:
            wire[Group.OP_NAMES[c.kind]] += c.nbytes
        rep.wire_by_collective = dict(wire)
    return rep
