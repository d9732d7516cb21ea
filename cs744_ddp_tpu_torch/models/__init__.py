"""Model zoo of the port: the VGG family (VGG-11 is the reference's model),
any configuration in ``vgg.CFG`` by its lower-case name."""

from __future__ import annotations

import torch

from . import layers, vgg


def get_model(name: str, seed: int = 0) -> vgg.VGG:
    """A freshly initialized model on the CPU, its weights drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    key = name.upper()
    if key not in vgg.CFG:
        raise ValueError(f"model {name!r} is not yet ported; expected one "
                         f"of {sorted(k.lower() for k in vgg.CFG)}")
    model = vgg.VGG(key)
    layers.reset_parameters(model, torch.Generator().manual_seed(seed))
    return model
