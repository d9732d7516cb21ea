"""Non-finite step guard: an on-device finiteness flag and an update that
keeps the prior state where the flag is down — the reference package's
``ft/guard.py``, inside the step that a CUDA graph captures.

A NaN/Inf loss or gradient poisons every later step.  The guard computes
``ok = isfinite(loss) & isfinite(sum_g ||g||^2)`` on the device (the same
squared norm the metric ring records, so one reduction) and applies the
step branch-free, ``where(ok, new, old)``:

* ok     -> the normal SGD update (parameters, BN statistics, momentum,
            comm state all advance);
* not ok -> every tensor the step carries keeps its prior bits, as if the
            batch had not been seen.

The reference selects the whole prior state with ``jnp.where``.  Here the
state is updated in place, so the guard selects at the point of each
write: ``ok`` depends only on the loss and the post-sync gradients, so it
is known before the update, which writes ``v <- where(ok, mu*v + g +
wd*p, v)`` and ``p <- where(ok, p - lr*v, p)`` in the roundings of
``ops/sgd.py`` for the large parameters; a stateful strategy's comm state
is copied the same way.  What a per-tensor ``where`` would cost in
launches rather than bytes (the module buffers, which the forward pass
updates, and the small parameters and their momentum) is snapshotted at
the start of the step into one flat buffer a dtype and selected back in
three launches (``StepGuard``).  ``where`` returns its first operand's
bits, so a guarded step with no fault is bitwise the unguarded one.  ``ok`` stays a device tensor: no
host sync.  Policy semantics live on the host in the Trainer: ``halt``
raises, ``skip`` counts and continues, ``restore`` also rolls the state
back to the last checkpoint snapshot.  With the policy ``off`` none of
this is built.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..ops.sgd import SGDConfig, SGDState
from ..ops.sgd import update as sgd_update


class NonFiniteError(RuntimeError):
    """Raised under ``--nonfinite=halt`` when a non-finite step is caught
    (the state has NOT absorbed the bad update: the on-device select kept
    the prior bits)."""


POLICIES = ("off", "halt", "skip", "restore")


def finite_ok(loss: torch.Tensor, grad_sqnorm: torch.Tensor
              ) -> torch.Tensor:
    """0-d bool device tensor: the loss and the squared gradient norm (NaN
    or Inf anywhere in any gradient propagates into it) are finite."""
    return torch.isfinite(loss) & torch.isfinite(grad_sqnorm)


@torch.no_grad()
def inject_nan(grads: Sequence[torch.Tensor], mask: torch.Tensor) -> None:
    """Chaos helper: add ``where(mask, nan, 0)`` to every gradient, in
    place.  ``mask`` is a 0-d bool device tensor, so the step stays one
    graph that poisons exactly the planned batches."""
    nan = torch.full((), float("nan"), device=mask.device)
    poison = torch.where(mask, nan, 0.0)
    # One add_ a gradient: _foreach_add_ of a device scalar reads it on
    # the host, which a CUDA graph cannot capture.
    for g in grads:
        g.add_(poison)


@torch.no_grad()
def guarded_update(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor], state: SGDState,
                   cfg: SGDConfig, ok: torch.Tensor) -> None:
    """``ops/sgd.update`` where ``ok``, a no-op where not: the same
    operations in the same order, each result written through ``where``."""
    for p, g, v in zip(params, grads, state.momentum):
        d = g + cfg.weight_decay * p
        torch.where(ok, v.mul(cfg.momentum).add_(d), v, out=v)
        torch.where(ok, p - cfg.lr * v, p, out=p)


def _memory(t: torch.Tensor) -> torch.Tensor:
    """A 1-D alias of a dense tensor's memory, in memory order (a
    channels_last weight too), so that a flat copy and a multi-tensor copy
    back need no layout change and take the multi-tensor fast path."""
    if not (t.is_contiguous()
            or (t.dim() == 4
                and t.is_contiguous(memory_format=torch.channels_last))):
        raise ValueError(f"cannot snapshot a tensor of strides {t.stride()}")
    return t.as_strided((t.numel(),), (1,), t.storage_offset())


class StepGuard:
    """What a guarded step keeps besides ``ok``: a snapshot taken at the
    start of the step, and the planned NaN batches.

    The snapshot holds the module buffers (the forward pass updates them)
    and the SMALL parameters and their momentum (fewer than ``SMALL``
    elements: biases, BN affine parameters, a small first or last layer).
    ``update`` applies the plain SGD update to the small ones and
    ``guarded_update`` to the large ones, then ``keep_if`` puts the
    snapshot back where not ``ok``.  A ``where`` a tensor costs a launch
    whatever its size; the snapshot is grouped by dtype into flat
    persistent buffers (each tensor in its memory order), so ``save`` is
    one concatenation and ``keep_if`` a concatenation, one ``where`` and
    one multi-tensor copy per group, however many small tensors and BN
    layers there are.  ``chaos_steps``
    are absolute batch indices, compared with the step's device index as
    the reference's window does (``cs744_ddp_tpu/train/step.py:362-366``).
    """

    SMALL = 1 << 16

    def __init__(self, buffers: Sequence[torch.Tensor],
                 params: Sequence[torch.Tensor],
                 chaos_steps: Sequence[int] = ()):
        self.buffers = list(buffers)
        self.params = [p.detach() for p in params]
        self.small = [i for i, p in enumerate(params)
                      if p.numel() < self.SMALL]
        self.large = [i for i, p in enumerate(params)
                      if p.numel() >= self.SMALL]
        self.chaos_steps = tuple(int(s) for s in chaos_steps)
        self.momentum: List[torch.Tensor] = []
        self.groups: List[Tuple[List[torch.Tensor], torch.Tensor,
                                torch.Tensor, List[torch.Tensor]]] = []

    def _bind(self, momentum: Sequence[torch.Tensor]) -> None:
        """The flat buffers, made at the first step (the momentum comes
        with the state the step is given); later steps must be given the
        same momentum tensors."""
        if self.momentum:
            if any(a is not b for a, b in zip(self.momentum, momentum)):
                raise ValueError("the guarded step was given other "
                                 "momentum tensors than at its first step")
            return
        self.momentum = list(momentum)
        kept = self.buffers + [self.params[i] for i in self.small] \
            + [self.momentum[i] for i in self.small]
        groups: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in kept:
            groups.setdefault(t.dtype, []).append(t)
        for ts in groups.values():
            mems = [_memory(t) for t in ts]
            n = sum(m.numel() for m in mems)
            snap = ts[0].new_empty(n)
            cur = ts[0].new_empty(n)
            self.groups.append((mems, snap, cur,
                                list(cur.split([m.numel() for m in mems]))))

    @torch.no_grad()
    def save(self, state: SGDState) -> None:
        """Snapshot the kept tensors (before the forward pass)."""
        self._bind(state.momentum)
        for mems, snap, _, _ in self.groups:
            torch.cat(mems, out=snap)

    @torch.no_grad()
    def keep_if(self, ok: torch.Tensor) -> None:
        """Kept tensors <- where(ok, kept tensors, snapshot)."""
        for mems, snap, cur, pieces in self.groups:
            torch.cat(mems, out=cur)
            torch.where(ok, cur, snap, out=cur)
            torch._foreach_copy_(mems, pieces)

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: SGDState,
               cfg: SGDConfig, ok: torch.Tensor) -> None:
        """The SGD update where ``ok``; where not, the parameters,
        momentum and buffers keep the bits they had when ``save`` ran."""
        pick = lambda xs, idx: [xs[i] for i in idx]  # noqa: E731
        guarded_update(pick(params, self.large), pick(grads, self.large),
                       SGDState(pick(state.momentum, self.large)), cfg, ok)
        sgd_update(pick(params, self.small), pick(grads, self.small),
                   SGDState(pick(state.momentum, self.small)), cfg)
        self.keep_if(ok)

    def inject(self, grads: Sequence[torch.Tensor],
               idx: torch.Tensor) -> None:
        """NaN into ``grads`` where ``idx`` is a planned batch."""
        if not self.chaos_steps:
            return
        mask = idx == self.chaos_steps[0]
        for s in self.chaos_steps[1:]:
            mask = mask | (idx == s)
        inject_nan(grads, mask)
