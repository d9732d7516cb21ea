"""Cross-entropy with torch.nn.CrossEntropyLoss semantics, reduced in f32,
and the masked evaluation counts (label -1 marks padding).

A token model's loss is over every position of its batch: logits
[rows * S, V], tens of thousands of rows of a vocabulary of tens of
thousands.  Above ``CHUNKED_ABOVE`` logits the mean keeps only the logits
and each row's logsumexp for its backward, and the softmax is formed
``CHUNK_ROWS`` rows at a time (``_ChunkedCrossEntropy``): the same mean, in
a few gigabytes less."""

from __future__ import annotations

from typing import Tuple

import torch


# Logits above which the mean cross-entropy is chunked, and the rows a
# chunk takes (f32 temporaries of CHUNK_ROWS x V).
CHUNKED_ABOVE = 1 << 26
CHUNK_ROWS = 8192


class _ChunkedCrossEntropy(torch.autograd.Function):
    """``cross_entropy`` of large logits: each row's logsumexp in f32 a
    chunk of rows at a time, the mean over all rows at once; the backward
    (softmax - onehot) / N, in f32 a chunk at a time, in the logits'
    dtype."""

    @staticmethod
    def forward(ctx, logits, labels):
        labels = labels.long()
        logz = torch.cat([torch.logsumexp(part.to(torch.float32), dim=-1)
                          for part in logits.split(CHUNK_ROWS)])
        picked = logits.gather(1, labels[:, None])[:, 0].to(torch.float32)
        ctx.save_for_backward(logits, labels, logz)
        return torch.mean(logz - picked)

    @staticmethod
    def backward(ctx, g):
        logits, labels, logz = ctx.saved_tensors
        scale = g / logits.shape[0]
        out = torch.empty_like(logits)
        for lo in range(0, logits.shape[0], CHUNK_ROWS):
            hi = min(lo + CHUNK_ROWS, logits.shape[0])
            d = torch.exp(logits[lo:hi].to(torch.float32)
                          - logz[lo:hi, None]) * scale
            d.scatter_add_(1, labels[lo:hi, None],
                           (-scale).expand(hi - lo, 1))
            out[lo:hi] = d
        return out, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of -log softmax(logits)[label], computed in f32.

    logits: [N, C]; labels: [N] integer.  Above ``CHUNKED_ABOVE`` logits,
    ``_ChunkedCrossEntropy``."""
    if logits.numel() > CHUNKED_ABOVE:
        return _ChunkedCrossEntropy.apply(logits, labels)
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
