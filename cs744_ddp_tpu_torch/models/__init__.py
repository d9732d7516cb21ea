"""Model zoo of the port: the VGG family (VGG-11 is the reference's model)."""

from __future__ import annotations

import torch

from . import layers, vgg


def get_model(name: str, seed: int = 0) -> vgg.VGG:
    """A freshly initialized model on the CPU, its weights drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    key = name.lower()
    if key not in ("vgg11", "vgg13", "vgg16", "vgg19"):
        raise ValueError(f"model {name!r} is not yet ported; expected "
                         f"vgg11/13/16/19")
    model = vgg.VGG(key.upper())
    layers.reset_parameters(model, torch.Generator().manual_seed(seed))
    return model
