"""Train and eval steps of the ``single`` strategy (one device, no process
group): prepare -> forward in train mode -> mean CE -> backward -> SGD.

The reference package compiles this as one jitted program
(``train/step.py::make_train_step``, its ``local`` branch); here it runs
eagerly, and the pool-preceded BN blocks' backward launches the fused CUDA
kernels.  Training-mode BN uses the batch's own statistics and updates the
running statistics in the model's buffers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..data import augment as aug
from ..ops import sgd
from ..ops.loss import cross_entropy, masked_eval_counts


class TrainState(NamedTuple):
    model: nn.Module          # parameters; BN running statistics as buffers
    opt_state: sgd.SGDState   # momentum buffers


def init_train_state(model: nn.Module) -> TrainState:
    return TrainState(model, sgd.init(list(model.parameters())))


def prepare(images_u8: torch.Tensor, augment: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """uint8 [B,32,32,3] -> the model's f32 input [B,3,32,32] (channels_last):
    random crop/flip + normalize when ``augment``, else normalize only."""
    x = aug.augment(images_u8, generator) if augment \
        else aug.normalize(images_u8)
    return aug.to_model_input(x)


def make_train_step(model: nn.Module, cfg: sgd.SGDConfig = sgd.SGDConfig(),
                    *, augment: bool = True) -> Callable:
    """step(state, images_u8 [B,32,32,3], labels [B], generator) -> loss.

    ``state`` is ``init_train_state(model)``; the step updates the model's
    parameters, its BN running statistics and the momentum in place and
    returns the loss as a 0-d device tensor (not synchronised)."""
    params = list(model.parameters())

    def step(state: TrainState, images_u8: torch.Tensor,
             labels: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = prepare(images_u8, augment, generator)
        model.train()
        loss = cross_entropy(model(x), labels)
        grads = torch.autograd.grad(loss, params)
        sgd.update(params, grads, state.opt_state, cfg)
        return loss.detach()

    return step


def make_eval_step(model: nn.Module) -> Callable:
    """step(images_u8, labels) -> (loss_sum, correct) over the examples with
    label >= 0 (label -1 marks padding), running statistics in BN."""

    @torch.no_grad()
    def step(images_u8: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        logits = model(aug.to_model_input(aug.normalize(images_u8)))
        return masked_eval_counts(logits, labels)

    return step
