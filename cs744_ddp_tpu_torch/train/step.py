"""Train and eval steps: prepare -> forward in train mode -> mean CE ->
backward -> gradient sync -> SGD, then the BN running statistics and the
loss meaned over the ranks.

The reference package compiles this as one jitted ``shard_map`` program
(``train/step.py::make_train_step``); here it runs eagerly on each rank's
own rows of the batch, the strategy's collectives go over the process
group (``parallel/``), and the pool-preceded BN blocks' backward launches
the fused CUDA kernels.  Training-mode BN uses the rank's own batch
statistics and updates the running statistics in the model's buffers.
The ``single`` strategy is the plain step with no process group, as the
reference's Part 1 has no ``torch.distributed`` code.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ..data import augment as aug
from ..ops import sgd
from ..ops.loss import cross_entropy, masked_eval_counts
from ..parallel import strategies
from ..parallel.mesh import Group


class TrainState(NamedTuple):
    model: nn.Module          # parameters; BN running statistics as buffers
    opt_state: sgd.SGDState   # momentum buffers, a strategy's comm state


def init_train_state(model: nn.Module, strategy=None) -> TrainState:
    """A STATEFUL ``strategy`` (the compressed tiers) adds this rank's comm
    state to ``SGDState.comm``; the others leave it None."""
    opt = sgd.init(list(model.parameters()))
    if strategy is not None and getattr(strategy, "stateful", False):
        opt = opt._replace(comm=strategy.init_comm(model.named_parameters()))
    return TrainState(model, opt)


def apply_strategy(strategy, grads, group: Group, comm):
    """Run the gradient-sync strategy, threading comm state: stateful
    strategies are ``(grads, group, comm) -> (grads, comm')``, stateless
    ones ``(grads, group) -> grads`` and pass ``comm`` through."""
    if getattr(strategy, "stateful", False):
        return strategy(grads, group, comm)
    return strategy(grads, group), comm


def prepare(images_u8: torch.Tensor, augment: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """uint8 [B,32,32,3] -> the model's f32 input [B,3,32,32] (channels_last):
    random crop/flip + normalize when ``augment``, else normalize only."""
    x = aug.augment(images_u8, generator) if augment \
        else aug.normalize(images_u8)
    return aug.to_model_input(x)


def _bn_statistics(model: nn.Module) -> Sequence[torch.Tensor]:
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def mean_over_ranks(tensors: Sequence[torch.Tensor], world: int) -> None:
    """Replace each tensor by its mean over the ranks, in place, through ONE
    all-reduce of one flat buffer.  Not a strategy collective: it goes to
    ``torch.distributed`` directly and stays out of the strategy's count."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def make_train_step(model: nn.Module, strategy=strategies.local,
                    cfg: sgd.SGDConfig = sgd.SGDConfig(), *,
                    augment: bool = True,
                    group: Optional[Group] = None) -> Callable:
    """step(state, images_u8 [B,32,32,3], labels [B], generator) -> loss.

    ``images_u8``/``labels`` are this rank's rows of the global batch and
    ``state`` is ``init_train_state(model, strategy)``.  The step updates
    the model's parameters, its BN running statistics, the momentum and
    the comm state in place and returns the loss (meaned over the ranks)
    as a 0-d device tensor, not synchronised.  ``group.step_counts`` holds
    the step's strategy collectives afterwards."""
    params = list(model.parameters())
    single = strategy is strategies.local
    if single and group is not None and group.world != 1:
        raise ValueError("'single' strategy requires world 1 (reference "
                         "Part 1 is world_size==1), got world "
                         f"{group.world}")
    if not single and group is None:
        raise ValueError("a gradient-sync strategy needs a process group")
    stats = _bn_statistics(model)
    overlap = strategy.attach(params, group) \
        if hasattr(strategy, "attach") else None

    def step(state: TrainState, images_u8: torch.Tensor,
             labels: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = prepare(images_u8, augment, generator)
        model.train()
        loss = cross_entropy(model(x), labels)
        if single:
            grads = torch.autograd.grad(loss, params)
            sgd.update(params, grads, state.opt_state, cfg)
            return loss.detach()
        group.reset_step()
        if overlap is not None:
            overlap.begin()
            torch.autograd.grad(loss, params)
            grads = overlap.finish()
        else:
            grads = list(torch.autograd.grad(loss, params))
            comm = state.opt_state.comm
            grads, new_comm = apply_strategy(strategy, grads, group, comm)
            if new_comm is not None:
                comm.update(new_comm)
        sgd.update(params, grads, state.opt_state, cfg)
        loss = loss.detach().reshape(1)
        with torch.no_grad():
            mean_over_ranks(list(stats) + [loss], group.world)
        return loss[0]

    return step


def make_eval_step(model: nn.Module, group: Optional[Group] = None
                   ) -> Callable:
    """step(images_u8, labels) -> (loss_sum, correct) over the examples with
    label >= 0 (label -1 marks padding), running statistics in BN, summed
    over the ranks when there is more than one."""

    @torch.no_grad()
    def step(images_u8: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        logits = model(aug.to_model_input(aug.normalize(images_u8)))
        loss_sum, correct = masked_eval_counts(logits, labels)
        if group is None or group.world == 1:
            return loss_sum, correct
        # Counts up to 2**24 are exact in f32.
        both = torch.stack([loss_sum, correct.float()])
        dist.all_reduce(both)
        return both[0], both[1].long()

    return step
