"""The fused-ingest serving forward: uint8 at the program edge — the
reference package's ``models/serving.py``.

``make_u8_forward`` takes the wire format (uint8 CIFAR rows, NHWC) as its
input and normalizes inside the forward, so a caller ships a staged uint8
batch (4x smaller than f32) to the device.  Rows labelled -1 are padding
and are masked out of the counts (``ops/loss.py::masked_eval_counts``, as
eval does); with eval-mode BatchNorm every row is independent of its
batchmates, so padding a batch leaves the other rows' logits unchanged.
Nothing on the training path uses it; the serving engine will.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from ..data import augment as aug
from ..ops.loss import masked_eval_counts

#: Identity of the fused-ingest forward, for executable cache keys: bump
#: it whenever the program edge changes (dtype, normalize, masking).
INGEST_VERSION = "fused-u8-v1"


def make_u8_forward(model: nn.Module, compute_dtype: Optional[torch.dtype]
                    = None) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """forward(images_u8 [N,32,32,3], labels [N]) -> (logits [N,10] f32,
    loss_sum, correct) of ``model`` in eval mode (running statistics).

    ``compute_dtype`` (None: f32) is the dtype the normalized input is
    cast to, as the train and eval programs cast it; logits come back f32
    whatever it is."""
    stats = aug.channel_stats(next(model.parameters()).device)

    @torch.no_grad()
    def forward(images_u8: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        model.eval()
        x = aug.cast(aug.to_model_input(aug.normalize(images_u8, stats)),
                     compute_dtype)
        logits = model(x).to(torch.float32)
        loss_sum, correct = masked_eval_counts(logits, labels)
        return logits, loss_sum, correct

    return forward
