"""Augmentation on the device: pad-4 random crop + horizontal flip +
channel normalization, on uint8 NHWC batches.

The reference train transform is RandomCrop(32, padding=4) ->
RandomHorizontalFlip -> ToTensor -> Normalize; the test transform is
ToTensor -> Normalize.  Random offsets and flips come from an explicit
``torch.Generator``.  They cannot reproduce the reference package's JAX
threefry draws, so parity runs use ``augment=False``; ``crop_flip`` takes
offsets and flips as arguments so tests can feed both sides the same
numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cifar10 import MEAN, STD

PAD = 4


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [.,32,32,3] -> float32 (x/255 - mean)/std: ToTensor+Normalize."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.from_numpy(MEAN).to(x.device)
    std = torch.from_numpy(STD).to(x.device)
    return (x - mean) / std


def crop_flip(images_u8: torch.Tensor, offsets: torch.Tensor,
              flips: torch.Tensor) -> torch.Tensor:
    """Zero-pad by 4, crop 32x32 at ``offsets`` [N,2] (row, col in [0,8]),
    then mirror the columns where ``flips`` [N] is true.  uint8 in and out."""
    n, h, w, _ = images_u8.shape
    padded = torch.nn.functional.pad(images_u8, (0, 0, PAD, PAD, PAD, PAD))
    ar_h = torch.arange(h, device=images_u8.device)
    ar_w = torch.arange(w, device=images_u8.device)
    rows = offsets[:, 0:1] + ar_h[None, :]                       # [N,32]
    src_w = torch.where(flips[:, None], (w - 1) - ar_w[None, :], ar_w[None, :])
    cols = offsets[:, 1:2] + src_w                               # [N,32]
    batch = torch.arange(n, device=images_u8.device)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]


def augment(images_u8: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Random pad-4 crop + hflip + normalize of a uint8 [N,32,32,3] batch;
    draws on ``generator``, which must live on the batch's device."""
    n = images_u8.shape[0]
    dev = images_u8.device
    offsets = torch.randint(0, 2 * PAD + 1, (n, 2), generator=generator,
                            device=dev)
    flips = torch.rand(n, generator=generator, device=dev) < 0.5
    return normalize(crop_flip(images_u8, offsets, flips))


def to_model_input(x_nhwc: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> the model's NCHW-logical view.  For a contiguous NHWC
    tensor this view is already ``torch.channels_last``: no copy."""
    return x_nhwc.permute(0, 3, 1, 2)
