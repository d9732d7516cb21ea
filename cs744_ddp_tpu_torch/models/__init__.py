"""Model zoo of the port: the VGG family (VGG-11 is the reference's model;
any configuration in ``vgg.CFG`` by its lower-case name) and ResNet-18/34
(the scaling stress models), as the reference package's
``models/__init__.py``; Moonlight-16B-A3B as one chip of an
expert-parallel deployment (``models/moonlight.py``), a token model; plus
any model plugged in with ``register_model``."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn as nn

from . import layers, moonlight, resnet, vgg

RESNETS = {"resnet18": "ResNet18", "resnet-18": "ResNet18",
           "resnet34": "ResNet34", "resnet-34": "ResNet34"}
# Token models by name: their configurations.
MOONLIGHT = {"moonlight-16b-a3b-ep8": moonlight.MOONLIGHT_16B_A3B_EP8}
# Plugged-in models: lower-case name -> factory() -> a fresh nn.Module.
_CUSTOM: Dict[str, Callable[[], nn.Module]] = {}


def register_model(name: str, factory: Callable[[], nn.Module]) -> None:
    """Register ``factory() -> nn.Module`` under ``name`` (case-blind), for
    the Trainer, the CLI and every other caller of ``get_model``; a
    factory's ``input_kind`` attribute (``"tokens"``), if it has one, says
    what the model takes."""
    _CUSTOM[name.lower()] = factory


def model_names() -> List[str]:
    return sorted([k.lower() for k in vgg.CFG] + list(RESNETS)
                  + list(MOONLIGHT) + list(_CUSTOM))


def input_kind(name: str) -> str:
    """What the model ``name`` takes: ``"images"`` (uint8 [B, 32, 32, 3])
    or ``"tokens"`` (int ids [B, S]), without building it."""
    key = name.lower()
    if key in _CUSTOM:
        return getattr(_CUSTOM[key], "input_kind", "images")
    return moonlight.INPUT_KIND if key in MOONLIGHT else "images"


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
    elif key in MOONLIGHT:
        model = moonlight.Moonlight(MOONLIGHT[key])
    else:
        raise ValueError(f"unknown model {name!r}; expected one of "
                         f"{model_names()}")
    layers.reset_parameters(model, torch.Generator().manual_seed(seed))
    return model
