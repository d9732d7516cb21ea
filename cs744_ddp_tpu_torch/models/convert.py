"""Carry VGG weights, and a compressed strategy's comm state, between the
reference package's pytree layout and the port's.

The reference layout (``models/vgg.py::init`` there), as NumPy arrays:
``params = {"conv": [{"w": HWIO, "b"}], "bn": [{"gamma", "beta"}],
"fc1": {"w": [in, out], "b"}}`` and ``state = {"bn": [{"mean", "var"}]}``.
Conv weights go HWIO <-> OIHW and linear weights [in,out] <-> [out,in];
BatchNorm parameters and running statistics carry over as they are.

Comm state: the reference stacks every worker's residuals (a params-like
pytree with a leading world axis) and keys PowerSGD's Q factors by leaf
index (``"000"``, ... in ``jax.tree.leaves`` order of the params); each
port rank holds its own residuals as a list in parameter order and its Q
factors keyed by parameter name, in the reference's matrix view (so a Q
needs no layout change).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference params (or a params-like pytree) -> {port parameter name:
    tensor}, in the port's registration order."""
    sd = {}
    for i, (conv, bn) in enumerate(zip(params["conv"], params["bn"])):
        p = f"blocks.{i}."
        sd[p + "conv.weight"] = _t(np.transpose(conv["w"], (3, 2, 0, 1)))
        sd[p + "conv.bias"] = _t(conv["b"])
        sd[p + "bn.weight"] = _t(bn["gamma"])
        sd[p + "bn.bias"] = _t(bn["beta"])
    sd["fc1.weight"] = _t(np.transpose(params["fc1"]["w"]))
    sd["fc1.bias"] = _t(params["fc1"]["b"])
    return sd


def params_to_jax(named: Dict[str, Any]) -> Dict[str, Any]:
    """{port parameter name: tensor or array} -> reference params."""

    def a(key):
        return _np(named[key])

    params = {"conv": [], "bn": []}
    for i in range(_num_blocks(named)):
        p = f"blocks.{i}."
        params["conv"].append({
            "w": np.ascontiguousarray(
                np.transpose(a(p + "conv.weight"), (2, 3, 1, 0))),
            "b": a(p + "conv.bias")})
        params["bn"].append({"gamma": a(p + "bn.weight"),
                             "beta": a(p + "bn.bias")})
    params["fc1"] = {"w": np.ascontiguousarray(a("fc1.weight").T),
                     "b": a("fc1.bias")}
    return params


def _num_blocks(names) -> int:
    return 1 + max(int(k.split(".")[1]) for k in names
                   if k.startswith("blocks."))


def param_names(num_blocks: int) -> List[str]:
    """The port's parameter names in registration order."""
    names = []
    for i in range(num_blocks):
        names += [f"blocks.{i}.{m}" for m in ("conv.weight", "conv.bias",
                                              "bn.weight", "bn.bias")]
    return names + ["fc1.weight", "fc1.bias"]


def jax_leaf_names(num_blocks: int) -> List[str]:
    """The port's parameter names in the reference's leaf order
    (``jax.tree.leaves`` sorts dict keys: bn beta/gamma, conv b/w, fc1
    b/w)."""
    bn = [f"blocks.{i}.bn.{m}" for i in range(num_blocks)
          for m in ("bias", "weight")]
    conv = [f"blocks.{i}.conv.{m}" for i in range(num_blocks)
            for m in ("bias", "weight")]
    return bn + conv + ["fc1.bias", "fc1.weight"]


def from_jax(params: Dict[str, Any], state: Dict[str, Any]
             ) -> Dict[str, torch.Tensor]:
    """Reference (params, state) of NumPy arrays -> the port's state_dict."""
    sd = params_from_jax(params)
    for i, st in enumerate(state["bn"]):
        p = f"blocks.{i}.bn."
        sd[p + "running_mean"] = _t(st["mean"])
        sd[p + "running_var"] = _t(st["var"])
        sd[p + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def to_jax(sd: Dict[str, torch.Tensor]
           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's state_dict -> reference (params, state) of NumPy arrays."""
    state = {"bn": [{"mean": sd[f"blocks.{i}.bn.running_mean"].cpu().numpy(),
                     "var": sd[f"blocks.{i}.bn.running_var"].cpu().numpy()}
                    for i in range(_num_blocks(sd))]}
    return params_to_jax(sd), state


def _rank_slice(tree, rank: int):
    if isinstance(tree, dict):
        return {k: _rank_slice(v, rank) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rank_slice(v, rank) for v in tree]
    return np.asarray(tree)[rank]


def comm_from_jax(comm: Dict[str, Any], rank: int) -> Dict[str, Any]:
    """Rank ``rank``'s slice of the reference's stacked comm state (NumPy
    arrays) -> the port's comm state for that rank."""
    res = params_from_jax(_rank_slice(comm["residual"], rank))
    out = {"residual": list(res.values())}
    if "q" in comm:
        names = jax_leaf_names(_num_blocks(res))
        order = {n: k for k, n in enumerate(res)}
        qs = {names[int(k)]: _t(np.asarray(v)[rank])
              for k, v in comm["q"].items()}
        out["q"] = dict(sorted(qs.items(), key=lambda kv: order[kv[0]]))
    return out


def comm_to_jax(per_rank: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Every rank's port comm state (tensors or arrays), in rank order ->
    the reference's stacked layout (NumPy arrays)."""
    names = param_names((len(per_rank[0]["residual"]) - 2) // 4)
    trees = [params_to_jax(dict(zip(names, c["residual"])))
             for c in per_rank]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        if isinstance(leaves[0], list):
            return [stack(*ls) for ls in zip(*leaves)]
        return np.stack(leaves)

    out = {"residual": stack(*trees)}
    if "q" in per_rank[0]:
        index = {n: k for k, n in enumerate(
            jax_leaf_names((len(names) - 2) // 4))}
        out["q"] = {f"{index[n]:03d}": np.stack(
            [_np(c["q"][n]) for c in per_rank])
            for n in per_rank[0]["q"]}
    return out
