"""The gradient-sync strategies as ``torch.distributed`` collective
patterns — the reference package's ``parallel/strategies.py``, on a
process group instead of a mesh axis.

Every strategy takes this rank's gradients as a list, one per parameter in
registration order, and the ``mesh.Group`` whose counted collectives it
calls; it returns the mean over the ranks, the same on every rank.  A
strategy may reduce the tensors it is given in place.

  * ``local``          — reference Part 1: one process, no sync.
  * ``gather_scatter`` — reference Part 2a (``main.py:117-127``): per
    parameter, in sequence, ``gather`` to rank 0, the mean there, then
    ``scatter`` back: two blocking collectives per parameter.
  * ``per_param_psum`` — reference Part 2b (``main.py:116-119``): one
    blocking ``all_reduce`` per parameter, in sequence.
  * ``bucketed_psum``  — reference Part 3 (``DDP(model)``): each bucket of
    the plan (``bucketing.make_plan``, ~25 MiB) flattened into one buffer
    and all-reduced, one bucket after the other.
  * ``overlapped_ddp`` — the same buckets, each launched asynchronously;
    in the train step each is launched from inside backward as soon as
    its last gradient exists (``BackwardOverlap``), as torch DDP's reducer
    does.  torch's ``DistributedDataParallel`` is not used: it would
    overwrite the BN running statistics with rank 0's (the reference means
    them), it caps its first bucket at 1 MiB, and its reducer hides the
    collectives from the count.

The compressed tiers carry per-rank state, ``init_comm(named_params)``,
in ``SGDState.comm``: ``CompressedPsum`` (bf16 or int8 on the wire, with
error-feedback residuals) and ``PowerSGD`` (rank-r factors).  Each rank
holds only its own state; the reference package stacks every worker's on a
leading mesh axis (``models/convert.py`` maps between the two).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .bucketing import (BucketPlan, DEFAULT_BUCKET_BYTES, make_plan,
                        make_schedule)
from .mesh import Group

Strategy = Callable[..., Any]
Grads = List[torch.Tensor]

DEFAULT_COMPRESS_RANK = 4       # PowerSGD rank, the reference's default
Q_SEED = 0x9D5C                 # PowerSGD's Q cold start (reference key)


def local(grads: Sequence[torch.Tensor], group: Optional[Group] = None
          ) -> Grads:
    """No synchronization (single-worker Part-1 semantics)."""
    del group
    return list(grads)


def per_param_psum(grads: Sequence[torch.Tensor], group: Group) -> Grads:
    """One blocking all-reduce per parameter, in sequence; sum / world."""
    out = []
    for g in grads:
        group.all_reduce(g)
        out.append(g.div_(group.world))
    return out


def gather_scatter(grads: Sequence[torch.Tensor], group: Group) -> Grads:
    """Part 2a: per parameter, gather to rank 0, mean there, scatter."""
    out = []
    for g in grads:
        gathered = group.gather(g)
        chunks = None
        if gathered is not None:
            mean = torch.empty_like(g).copy_(torch.stack(gathered).mean(0))
            chunks = [mean] * group.world
        o = torch.empty_like(g)
        group.scatter(o, chunks)
        out.append(o)
    return out


def _flatten(grads: Sequence[torch.Tensor], bucket: Tuple[int, ...],
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    return torch.cat([grads[i].reshape(-1) for i in bucket], out=out)


def _unflatten(flat: torch.Tensor, bucket: Tuple[int, ...],
               like: Sequence[torch.Tensor], out: List) -> None:
    """Views of ``flat`` shaped like the bucket's leaves, into ``out``."""
    off = 0
    for i in bucket:
        n = like[i].numel()
        out[i] = flat[off:off + n].view(like[i].shape)
        off += n


def bucketed_psum(grads: Sequence[torch.Tensor], group: Group, *,
                  plan: Optional[BucketPlan] = None,
                  bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> Grads:
    """Part 3: one all-reduce per bucket of one flat buffer, each waited
    before the next starts (the reference package chains its buckets)."""
    if plan is None:
        plan = make_plan(grads, bucket_bytes)
    out: List = [None] * len(grads)
    for bucket in plan.buckets:
        flat = _flatten(grads, bucket)
        group.all_reduce(flat)
        _unflatten(flat.div_(group.world), bucket, grads, out)
    return out


class OverlappedDDP:
    """The overlap tier: ``bucketed_psum``'s buckets with no chain between
    them.  Called on finished gradients it launches every bucket
    asynchronously and waits for them after; the train step instead
    ``attach``es it to the parameters, so that backward launches each
    bucket itself (``BackwardOverlap``)."""

    name = "overlap"

    def __init__(self, bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        self.bucket_bytes = bucket_bytes

    def __call__(self, grads: Sequence[torch.Tensor], group: Group, *,
                 plan: Optional[BucketPlan] = None) -> Grads:
        if plan is None:
            plan = make_plan(grads, self.bucket_bytes)
        order = make_schedule(plan).order
        flats = {b: _flatten(grads, plan.buckets[b]) for b in order}
        works = {b: group.all_reduce(flats[b], async_op=True) for b in order}
        out: List = [None] * len(grads)
        for b in order:
            works[b].wait()
            _unflatten(flats[b].div_(group.world), plan.buckets[b], grads,
                       out)
        return out

    def attach(self, params: Sequence[torch.Tensor], group: Group
               ) -> "BackwardOverlap":
        return BackwardOverlap(params, group,
                               make_plan(params, self.bucket_bytes))


class BackwardOverlap:
    """Launches each bucket's all-reduce from inside backward.

    A hook on every parameter (``Tensor.register_hook``, which fires under
    ``torch.autograd.grad`` as well) keeps the parameter's gradient; when
    the last of a bucket's gradients has arrived (normally its gate leaf,
    ``bucketing.make_schedule``), the hook copies the bucket into its flat
    buffer and launches the all-reduce asynchronously, while backward goes
    on with earlier layers.  ``finish`` waits for every bucket.  The hooks
    act only between ``begin`` and ``finish``."""

    def __init__(self, params: Sequence[torch.Tensor], group: Group,
                 plan: BucketPlan):
        self.params = list(params)
        self.group = group
        self.plan = plan
        self.order = make_schedule(plan).order
        self.bucket_of = {i: b for b, bucket in enumerate(plan.buckets)
                          for i in bucket}
        self.flats = [self.params[bucket[0]].new_empty(
            sum(self.params[i].numel() for i in bucket))
            for bucket in plan.buckets]
        self.armed = False
        self.hooks = [p.register_hook(partial(self._arrive, i))
                      for i, p in enumerate(self.params)]

    def begin(self) -> None:
        self.grads: List = [None] * len(self.params)
        self.missing = [len(b) for b in self.plan.buckets]
        self.works: List = [None] * self.plan.num_buckets
        self.armed = True

    def _arrive(self, i: int, grad: torch.Tensor) -> None:
        if not self.armed:
            return None
        self.grads[i] = grad
        b = self.bucket_of[i]
        self.missing[b] -= 1
        if self.missing[b] == 0:
            _flatten(self.grads, self.plan.buckets[b], out=self.flats[b])
            self.works[b] = self.group.all_reduce(self.flats[b],
                                                  async_op=True)
        return None

    def finish(self) -> Grads:
        """Wait for every bucket; the mean gradients (views of the flat
        buffers, valid until the next ``begin``)."""
        self.armed = False
        out: List = [None] * len(self.params)
        for b in self.order:
            if self.works[b] is None:
                raise RuntimeError(f"overlap bucket {b} did not get all its "
                                   f"gradients in backward")
            self.works[b].wait()
            _unflatten(self.flats[b].div_(self.group.world),
                       self.plan.buckets[b], self.params, out)
        self.grads = []
        return out

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()


overlapped_ddp = OverlappedDDP()


def _zero_residuals(named_params) -> List[torch.Tensor]:
    return [torch.zeros_like(p, dtype=torch.float32) for _, p in named_params]


class CompressedPsum:
    """bf16 / int8 all-reduce with error feedback (the reference package's
    ``CompressedPsum``).

    Per parameter: ``v = g + residual``; quantize ``v``; all-reduce the
    quantized values; the mean is the dequantized sum / world, and the new
    residual ``v - dequant(quant(v))`` is what this rank failed to send.
    int8 shares one scale per parameter: the |v| maxima of all parameters
    go through ONE all-reduce MAX, then ``q = clip(round(v / scale), -L,
    L)`` with ``L = 127 // world`` and ``scale = amax / L``, so that the
    int8 sum cannot overflow.  A non-finite maximum is sent as +Inf, so
    that a NaN or Inf gradient on any rank makes every rank's mean
    non-finite (the non-finite guard reads it there); the reference's
    scale turns a NaN maximum into 1.0.  With ``comm=None`` it compresses without
    error feedback."""

    stateful = True

    def __init__(self, qdtype: str = "bf16"):
        if qdtype not in ("bf16", "int8"):
            raise ValueError(f"qdtype must be bf16 or int8, got {qdtype!r}")
        self.qdtype = qdtype

    @property
    def name(self) -> str:
        return f"compress-{self.qdtype}"

    def init_comm(self, named_params) -> Dict[str, Any]:
        return {"residual": _zero_residuals(list(named_params))}

    def __call__(self, grads: Sequence[torch.Tensor], group: Group,
                 comm: Optional[Dict[str, Any]] = None):
        world = group.world
        vs = [g.float() for g in grads]
        if comm is not None:
            vs = [v + r for v, r in zip(vs, comm["residual"])]
        limit = max(1, 127 // world)
        if self.qdtype == "int8":
            amax = torch.stack([v.abs().max() for v in vs])
            # A non-finite gradient on any rank must reach every rank's
            # output, as a sum all-reduce carries it: int8 cannot hold a
            # NaN, and a MAX over the ranks may drop one, so it goes on
            # the wire as +Inf, whose scale makes the output non-finite.
            amax = torch.where(torch.isfinite(amax), amax, float("inf"))
            group.all_reduce_max(amax)
            # amax / L as XLA computes it: times the f32 reciprocal of L,
            # so that both packages quantize with the same scale.
            scales = torch.where(amax > 0.0, amax * (1.0 / limit), 1.0)
        out, new_rs = [], []
        for i, (g, v) in enumerate(zip(grads, vs)):
            if self.qdtype == "bf16":
                q = v.to(torch.bfloat16)
                new_rs.append(v - q.float())         # exact in f32
                group.all_reduce(q)
                avg = q.float() / world
            else:
                q = torch.clamp(torch.round(v / scales[i]), -limit,
                                limit).to(torch.int8)
                # v - q * scale exactly: it is at most scale / 2 and, like
                # both terms, a multiple of half an ulp of scale, so an f32
                # number, which f64 arithmetic reaches without rounding (as
                # XLA's fused multiply-add does).  Rounding q * scale to
                # f32 first would not.
                new_rs.append((v.double() - q.double() * scales[i].double())
                              .float())
                group.all_reduce(q)
                avg = q.float() * scales[i] / world
            out.append(avg.to(g.dtype))
        return out, (None if comm is None else {"residual": new_rs})


def reference_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """A port parameter's shape in the reference package's layout: conv
    OIHW -> HWIO, linear [out, in] -> [in, out]; others as they are."""
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    if len(shape) == 2:
        return (shape[1], shape[0])
    return tuple(shape)


def _to_matrix(v: torch.Tensor) -> torch.Tensor:
    """The reference's matrix view of a port tensor:
    ``reference_shape`` reshaped to (prod(shape[:-1]), shape[-1])."""
    if v.dim() == 4:
        return v.permute(2, 3, 1, 0).reshape(-1, v.shape[0])
    if v.dim() == 2:
        return v.t()
    return v.reshape(-1, v.shape[-1])


def _from_matrix(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dim() == 4:
        o, i, h, w = like.shape
        return m.reshape(h, w, i, o).permute(3, 2, 0, 1)
    if like.dim() == 2:
        return m.t()
    return m.reshape(like.shape)


def _orthonormalize(p: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Modified Gram-Schmidt over the columns of a tall matrix, in the
    reference's order; a column numerically inside the span of the earlier
    ones is dropped to zero, not normalized (reference docstring)."""
    cols: List[torch.Tensor] = []
    for i in range(p.shape[1]):
        c = p[:, i]
        ref = torch.linalg.vector_norm(c)
        for u in cols:
            c = c - torch.dot(u, c) * u
        n = torch.linalg.vector_norm(c)
        keep = n > torch.clamp(ref * 1e-5, min=eps)
        c = torch.where(keep, c / torch.where(keep, n, torch.ones_like(n)),
                        torch.zeros_like(c))
        cols.append(c)
    return torch.stack(cols, dim=1)


class PowerSGD:
    """Rank-r gradient compression with warm-started Q and error feedback
    (Vogels et al. 2019; the reference package's ``PowerSGD``).

    Each parameter is compressed in the reference's matrix view
    (``_to_matrix``: an OIHW conv weight as [9*I, O], a linear weight as
    [in, out]), where ``P = mean(M @ Q)`` and ``Q' = mean(M^T @ P)`` are
    all-reduced instead of M; P is orthonormalized between the two, the
    update is ``P @ Q'^T`` and the residual ``M - P @ Q'^T``, both mapped
    back to the port's layout.  Parameters where low rank does not pay
    (vectors, or r(m+n) >= m*n) take the bf16 path inline.  Q's cold start
    is a normal draw from a ``torch.Generator`` seeded from (0x9D5C, the
    parameter's index); the comm state keys Q by parameter name."""

    stateful = True
    name = "powersgd"

    def __init__(self, rank: int = DEFAULT_COMPRESS_RANK):
        if rank < 1:
            raise ValueError(f"compress rank must be >= 1, got {rank}")
        self.rank = int(rank)

    def _low_rank(self, shape: Sequence[int]) -> bool:
        """Decided on the reference layout's shape."""
        if len(shape) < 2:
            return False
        m = 1
        for d in shape[:-1]:
            m *= int(d)
        n = int(shape[-1])
        return self.rank * (m + n) < m * n

    def _q_init(self, i: int, n: int, device: torch.device) -> torch.Tensor:
        gen = torch.Generator().manual_seed((Q_SEED << 32) + i)
        return torch.randn((n, self.rank), generator=gen).to(device)

    def init_comm(self, named_params) -> Dict[str, Any]:
        named = list(named_params)
        qs = {}
        for i, (name, p) in enumerate(named):
            shape = reference_shape(p.shape)
            if self._low_rank(shape):
                qs[name] = self._q_init(i, shape[-1], p.device)
        return {"residual": _zero_residuals(named), "q": qs}

    def __call__(self, grads: Sequence[torch.Tensor], group: Group,
                 comm: Optional[Dict[str, Any]] = None):
        world = group.world
        rs = comm["residual"] if comm is not None else [None] * len(grads)
        # The Q factors, in the order of the low-rank parameters.
        qs = iter(comm["q"].items()) if comm is not None else None
        out: List = [None] * len(grads)
        new_rs: List = [None] * len(grads)
        new_qs: Dict[str, torch.Tensor] = {}
        for i, (g, r) in enumerate(zip(grads, rs)):
            v = g.float()
            if r is not None:
                v = v + r
            if self._low_rank(reference_shape(g.shape)):
                mat = _to_matrix(v)
                if qs is None:
                    name, q = None, self._q_init(i, mat.shape[1], v.device)
                else:
                    name, q = next(qs)
                    if q.shape != (mat.shape[1], self.rank):
                        raise ValueError(f"Q of {name} is {tuple(q.shape)}, "
                                         f"parameter {i} needs "
                                         f"{(mat.shape[1], self.rank)}")
                p = mat @ q
                group.all_reduce(p)
                p = _orthonormalize(p / world)
                new_q = mat.t() @ p
                group.all_reduce(new_q)
                new_q = new_q / world
                approx = p @ new_q.t()
                out[i] = _from_matrix(approx, g).to(g.dtype)
                new_rs[i] = _from_matrix(mat - approx, g)
                new_qs[name] = new_q
            else:
                q16 = v.to(torch.bfloat16)
                new_rs[i] = v - q16.float()
                group.all_reduce(q16)
                out[i] = (q16.float() / world).to(g.dtype)
        if qs is not None and next(qs, None) is not None:
            raise ValueError("comm state holds more Q factors than the "
                             "gradients have low-rank parameters")
        new_comm = None if comm is None else {"residual": new_rs,
                                              "q": new_qs}
        return out, new_comm


STRATEGIES = {
    "single": local,
    "gather": gather_scatter,
    "allreduce": per_param_psum,
    "ddp": bucketed_psum,
    "overlap": overlapped_ddp,
    "compress-bf16": CompressedPsum("bf16"),
    "compress-int8": CompressedPsum("int8"),
    "powersgd": PowerSGD(),
}


def get_strategy(name: str, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 compress_rank: int = DEFAULT_COMPRESS_RANK) -> Strategy:
    """Resolve a CLI strategy name.  Stateless strategies are
    ``(grads, group) -> grads``; the compressed tiers have
    ``stateful = True``, are ``(grads, group, comm) -> (grads, comm')`` and
    have ``init_comm(named_params)``; the overlap tier has ``attach``
    (train/step.py dispatches on both)."""
    name = name.lower()
    if name not in STRATEGIES:
        raise ValueError(
            f"unknown strategy {name!r}; expected one of {sorted(STRATEGIES)}")
    if name == "ddp":
        return partial(bucketed_psum, bucket_bytes=bucket_bytes)
    if name == "overlap":
        return OverlappedDDP(bucket_bytes)
    if name == "powersgd" and compress_rank != DEFAULT_COMPRESS_RANK:
        return PowerSGD(compress_rank)
    return STRATEGIES[name]
