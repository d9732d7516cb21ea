"""Carry VGG weights between the reference package's pytree layout and the
port's ``state_dict``.

The reference layout (``models/vgg.py::init`` there), as NumPy arrays:
``params = {"conv": [{"w": HWIO, "b"}], "bn": [{"gamma", "beta"}],
"fc1": {"w": [in, out], "b"}}`` and ``state = {"bn": [{"mean", "var"}]}``.
Conv weights go HWIO <-> OIHW and linear weights [in,out] <-> [out,in];
BatchNorm parameters and running statistics carry over as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def from_jax(params: Dict[str, Any], state: Dict[str, Any]
             ) -> Dict[str, torch.Tensor]:
    """Reference (params, state) of NumPy arrays -> the port's state_dict."""
    sd = {}

    def t(a):
        return torch.from_numpy(np.array(a, np.float32, copy=True))

    for i, (conv, bn, st) in enumerate(zip(params["conv"], params["bn"],
                                           state["bn"])):
        p = f"blocks.{i}."
        sd[p + "conv.weight"] = t(np.transpose(conv["w"], (3, 2, 0, 1)))
        sd[p + "conv.bias"] = t(conv["b"])
        sd[p + "bn.weight"] = t(bn["gamma"])
        sd[p + "bn.bias"] = t(bn["beta"])
        sd[p + "bn.running_mean"] = t(st["mean"])
        sd[p + "bn.running_var"] = t(st["var"])
        sd[p + "bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    sd["fc1.weight"] = t(np.transpose(params["fc1"]["w"]))
    sd["fc1.bias"] = t(params["fc1"]["b"])
    return sd


def to_jax(sd: Dict[str, torch.Tensor]
           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's state_dict -> reference (params, state) of NumPy arrays."""

    def a(key):
        return sd[key].detach().cpu().numpy()

    nblocks = 1 + max(int(k.split(".")[1]) for k in sd
                      if k.startswith("blocks."))
    params = {"conv": [], "bn": []}
    state = {"bn": []}
    for i in range(nblocks):
        p = f"blocks.{i}."
        params["conv"].append({
            "w": np.ascontiguousarray(
                np.transpose(a(p + "conv.weight"), (2, 3, 1, 0))),
            "b": a(p + "conv.bias")})
        params["bn"].append({"gamma": a(p + "bn.weight"),
                             "beta": a(p + "bn.bias")})
        state["bn"].append({"mean": a(p + "bn.running_mean"),
                            "var": a(p + "bn.running_var")})
    params["fc1"] = {"w": np.ascontiguousarray(a("fc1.weight").T),
                     "b": a("fc1.bias")}
    return params, state
