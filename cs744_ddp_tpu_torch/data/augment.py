"""Augmentation on the device: pad-4 random crop + horizontal flip +
channel normalization, on uint8 NHWC batches.

The reference train transform is RandomCrop(32, padding=4) ->
RandomHorizontalFlip -> ToTensor -> Normalize; the test transform is
ToTensor -> Normalize.

The random offsets and flips are counter-keyed: a pure function of (seed,
rank, epoch, absolute batch index, row), computed on the device by a 32-bit
integer mix over int64 tensors (``draws``).  Nothing carries from one draw
to the next, so the per-step path and the windowed path (a CUDA graph
replayed over a device batch index) draw the same numbers, and so do the
CPU and the card.  The reference package counter-keys its draws too (a JAX
key folded with the epoch, the batch index and the mesh position,
``train/step.py::fold_and_prepare``); its threefry bits cannot be
reproduced here, so parity runs use ``augment=False``, and ``crop_flip``
takes offsets and flips as arguments so tests can feed both sides the same
numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .cifar10 import MEAN, STD

PAD = 4
_M32 = 0xFFFFFFFF
# Multipliers below 2**31: a 32-bit value times one stays below 2**63, so
# the int64 products never overflow before the mask.
_MUL1, _MUL2 = 0x45D9F3B, 0x2C1B3C6D


def channel_stats(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) per channel as f32 tensors on ``device``.  A step that is
    captured in a CUDA graph takes them made beforehand: a host-to-device
    copy cannot be captured."""
    return (torch.from_numpy(MEAN).to(device),
            torch.from_numpy(STD).to(device))


# The C++ host pipeline's normalize (native/fastloader.cpp) is the affine
# x * SCALE + BIAS, with SCALE and BIAS rounded to f32 as it rounds them.
# It differs from ``normalize``'s (x/255 - mean)/std by at most an ulp.
AFFINE_SCALE = (np.float32(1.0) / (np.float32(255.0) * STD)).astype(
    np.float32)
AFFINE_BIAS = (-MEAN / STD).astype(np.float32)


def affine_stats(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias) per channel of ``normalize_affine`` as f32 tensors on
    ``device``, made beforehand as ``channel_stats`` are."""
    return (torch.from_numpy(AFFINE_SCALE).to(device),
            torch.from_numpy(AFFINE_BIAS).to(device))


def normalize_affine(images_u8: torch.Tensor,
                     stats: Tuple[torch.Tensor, torch.Tensor]
                     ) -> torch.Tensor:
    """uint8 [.,32,32,3] -> float32 x * scale + bias, rounded after the
    product and after the sum: bit for bit the C++ host pipeline's f32
    output (``data/native.py::augment`` and ``normalize``)."""
    scale, bias = stats
    return images_u8.to(torch.float32).mul(scale).add(bias)


def normalize(images_u8: torch.Tensor,
              stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """uint8 [.,32,32,3] -> float32 (x/255 - mean)/std: ToTensor+Normalize."""
    x = images_u8.to(torch.float32) / 255.0
    mean, std = channel_stats(x.device) if stats is None else stats
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


def _mix32(x):
    """A 32-bit integer finalizer on an int64 tensor (or a Python int)
    holding values in [0, 2**32); the result is in the same range."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _M32
    return x ^ (x >> 16)


def stream_key(seed: int, rank: int) -> int:
    """The host part of the draw key: (seed, rank) mixed into 32 bits."""
    h = _mix32((seed & _M32) ^ 0x9E3779B9)
    h = _mix32(h ^ ((seed >> 32) & _M32))
    return _mix32(h ^ (rank & _M32))


def draws(n: int, key: int, epoch: torch.Tensor, idx: torch.Tensor,
          micro: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets [n,2] int64 in [0,8], flips [n] bool) of the batch at
    absolute index ``idx`` of ``epoch`` (int64 0-d tensors on the device the
    draws are made on), for the stream ``key`` (``stream_key``).  Row r's
    draws depend on (key, epoch, idx, r) alone.  ``micro``, the global
    microshard index of the elastic step (``elastic/step_elastic.py``), is
    folded in after the batch index, as the reference's elastic window
    folds it after the batch index: then row r is the microshard's row."""
    h = _mix32((epoch & _M32) ^ key)
    h = _mix32((idx & _M32) ^ h)
    if micro is not None:
        h = _mix32((micro & _M32) ^ h)
    rows = torch.arange(n, dtype=torch.int64, device=idx.device)
    base = _mix32(_mix32(rows) ^ h)
    lanes = torch.arange(1, 4, dtype=torch.int64, device=idx.device)
    v = _mix32(base[:, None] ^ lanes[None, :])                    # [n,3]
    return v[:, :2] % (2 * PAD + 1), (v[:, 2] >> 31).bool()


def augment(images_u8: torch.Tensor, key: int, epoch: torch.Tensor,
            idx: torch.Tensor,
            stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            micro: Optional[int] = None) -> torch.Tensor:
    """Random pad-4 crop + hflip + normalize of a uint8 [N,32,32,3] batch,
    drawn by ``draws``."""
    offsets, flips = draws(images_u8.shape[0], key, epoch, idx, micro)
    return normalize(crop_flip(images_u8, offsets, flips), stats)


def cast(x: torch.Tensor, compute_dtype: Optional[torch.dtype]
         ) -> torch.Tensor:
    """The model's input in the compute dtype (None: as it is): the
    reference's ``maybe_cast``, applied after normalize and augment."""
    return x if compute_dtype is None else x.to(compute_dtype)


def to_model_input(x_nhwc: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> the model's NCHW-logical view.  For a contiguous NHWC
    tensor this view is already ``torch.channels_last``: no copy."""
    return x_nhwc.permute(0, 3, 1, 2)
