"""The training transform, written out: pad-4 random crop, horizontal flip
and channel normalization of uint8 NHWC batches, with the counter-keyed
draws of the port's documented scheme.

The draws are a pure function of (seed, rank, epoch, batch index, row): a
32-bit integer finalizer over int64 tensors (multipliers below 2**31, so
no product overflows before the mask).  Normalization is
(x / 255 - mean) / std with the CS744 script's statistics.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MEAN = np.array([125.3, 123.0, 113.9], np.float32) / 255.0
STD = np.array([63.0, 62.1, 66.7], np.float32) / 255.0
PAD = 4
_M32 = 0xFFFFFFFF
_MUL1, _MUL2 = 0x45D9F3B, 0x2C1B3C6D


def mix32(x):
    """A 32-bit finalizer on an int64 tensor or a Python int in
    [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _M32
    return x ^ (x >> 16)


def stream_key(seed: int, rank: int) -> int:
    h = mix32((seed & _M32) ^ 0x9E3779B9)
    h = mix32(h ^ ((seed >> 32) & _M32))
    return mix32(h ^ (rank & _M32))


def draws(n: int, key: int, epoch: int, idx: int, device
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets [n,2] in [0, 8], flips [n] bool) of batch ``idx`` of
    ``epoch`` in the stream ``key``."""
    h = mix32((epoch & _M32) ^ key)
    h = mix32((idx & _M32) ^ h)
    rows = torch.arange(n, dtype=torch.int64, device=device)
    base = mix32(mix32(rows) ^ h)
    lanes = torch.arange(1, 4, dtype=torch.int64, device=device)
    v = mix32(base[:, None] ^ lanes[None, :])
    return v[:, :2] % (2 * PAD + 1), (v[:, 2] >> 31).bool()


def crop_flip(images: torch.Tensor, offsets: torch.Tensor,
              flips: torch.Tensor) -> torch.Tensor:
    """Zero-pad by 4, take the 32x32 window at each row's offsets, then
    mirror the columns of the rows whose flip is set."""
    n, h, w, _ = images.shape
    padded = torch.zeros((n, h + 2 * PAD, w + 2 * PAD, images.shape[3]),
                         dtype=images.dtype, device=images.device)
    padded[:, PAD:PAD + h, PAD:PAD + w] = images
    out = torch.empty_like(images)
    for i in range(n):
        r, c = int(offsets[i, 0]), int(offsets[i, 1])
        crop = padded[i, r:r + h, c:c + w]
        out[i] = crop.flip(1) if bool(flips[i]) else crop
    return out


def transform(images_u8: np.ndarray, seed: int, rank: int, epoch: int,
              idx: int, device) -> torch.Tensor:
    """uint8 [N,32,32,3] on the host -> the normalized f32 NCHW batch on
    ``device``: the draws and the crop on the host, the normalization on
    ``device``."""
    images = torch.from_numpy(np.ascontiguousarray(images_u8))
    offsets, flips = draws(images.shape[0], stream_key(seed, rank),
                           epoch, idx, "cpu")
    x = crop_flip(images, offsets, flips).to(device).to(torch.float32)
    mean = torch.from_numpy(MEAN).to(device)
    std = torch.from_numpy(STD).to(device)
    x = (x / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()
