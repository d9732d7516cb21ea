"""Model zoo of the port: the VGG family (VGG-11 is the reference's model;
any configuration in ``vgg.CFG`` by its lower-case name) and ResNet-18/34
(the scaling stress models), as the reference package's
``models/__init__.py``; plus any model plugged in with ``register_model``."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn as nn

from . import layers, resnet, vgg

RESNETS = {"resnet18": "ResNet18", "resnet-18": "ResNet18",
           "resnet34": "ResNet34", "resnet-34": "ResNet34"}
# Plugged-in models: lower-case name -> factory() -> a fresh nn.Module.
_CUSTOM: Dict[str, Callable[[], nn.Module]] = {}


def register_model(name: str, factory: Callable[[], nn.Module]) -> None:
    """Register ``factory() -> nn.Module`` under ``name`` (case-blind), for
    the Trainer, the CLI and every other caller of ``get_model``."""
    _CUSTOM[name.lower()] = factory


def model_names() -> List[str]:
    return sorted([k.lower() for k in vgg.CFG] + list(RESNETS)
                  + list(_CUSTOM))


def get_model(name: str, seed: int = 0) -> nn.Module:
    """A freshly initialized model on the CPU, its weights drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    key = name.lower()
    if key in _CUSTOM:
        model = _CUSTOM[key]()
    elif key.upper() in vgg.CFG:
        model = vgg.VGG(key.upper())
    elif key in RESNETS:
        model = resnet.ResNet(RESNETS[key])
    else:
        raise ValueError(f"unknown model {name!r}; expected one of "
                         f"{model_names()}")
    layers.reset_parameters(model, torch.Generator().manual_seed(seed))
    return model
