"""Cross-entropy with torch.nn.CrossEntropyLoss semantics, reduced in f32,
and the masked evaluation counts (label -1 marks padding)."""

from __future__ import annotations

from typing import Tuple

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of -log softmax(logits)[label], computed in f32.

    logits: [N, C]; labels: [N] integer."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - picked)


def masked_eval_counts(logits: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_sum, correct) over the valid (label >= 0) examples."""
    labels = labels.long()
    valid = labels >= 0
    safe = labels.clamp_min(0)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, safe[:, None])[:, 0]
    loss_sum = torch.where(valid, logz - picked, 0.0).sum()
    correct = (valid & (logits.argmax(dim=-1) == safe)).sum()
    return loss_sum, correct
