"""Device resolution and the f32 numerics switches.

The GPU is the default: ``resolve_device(None)`` is ``cuda``, and it raises
when no GPU is present instead of sliding onto the CPU.  The CPU is used only
when a caller asks for it (the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def set_f32_parity() -> None:
    """Full-f32 convolutions and matmuls on the GPU.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which would break parity with the f32 reference; matmuls are
    f32 by default but are pinned here too so the setting is explicit.
    Process-wide, as the two switches are."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
