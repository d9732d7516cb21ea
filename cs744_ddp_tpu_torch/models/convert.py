"""Carry a model's weights, and a compressed strategy's comm state, between
the reference package's pytree layout and the port's, for every model of
the zoo.

The reference layout is a tree of dicts and lists of NumPy arrays: a
layer is a dict of ``{"w", "b"}`` (conv HWIO, linear [in, out]; no ``"b"``
for a bias-free conv) or ``{"gamma", "beta"}`` (BatchNorm), and the BN
running statistics are a second tree of ``{"mean", "var"}``.  The port's
names follow the tree's keys and list indices, joined by dots:

  * ResNet: ``params["blocks"][3]["down_conv"]["w"]`` is
    ``blocks.3.down_conv.weight``, ``state["stem_bn"]["var"]`` is
    ``stem_bn.running_var``;
  * VGG: the one tree whose lists run across the blocks:
    ``params["conv"][i]`` and ``params["bn"][i]`` are the port's
    ``blocks.i.conv`` and ``blocks.i.bn``.

A module whose name contains ``bn`` is a BatchNorm (weight/bias are gamma/
beta), any other holds w/b.  Conv weights go HWIO <-> OIHW (3x3 and 1x1
alike), linear weights [in,out] <-> [out,in]; vectors carry over as they
are.  Nothing counts blocks: both directions walk the names they are given.

The serving tree (``serving_leaves``, ``serving_signature``,
``state_dict_from_leaves``) is what a published weight bundle holds
(``publish/``): the leaves of the reference's
``jax.tree_util.tree_flatten((params, bn_state))`` and that treedef's
``str``, rendered here without JAX, so that a bundle of either package
validates against an engine of either.

Comm state: the reference stacks every worker's residuals (a params-like
pytree with a leading world axis) and keys PowerSGD's Q factors by leaf
index (``"000"``, ... in ``jax.tree.leaves`` order of the params, which
sorts dict keys: for a ResNet ``blocks[i].{bn1, bn2, conv1, conv2,
down_bn, down_conv}``, then ``fc``, ``stem_bn``, ``stem_conv``).  Each
port rank holds its own residuals as a list in parameter order and its Q
factors keyed by parameter name, in the reference's matrix view (so a Q
needs no layout change).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[Any, ...]
_CROSS = ("conv", "bn")          # the VGG's lists that run across blocks
_STATS = {"mean": "running_mean", "var": "running_var"}
_SKIPPED = ("num_batches_tracked",)   # a port buffer the reference lacks


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _walk(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) in ``jax.tree.leaves`` order: dict keys sorted, lists
    in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _build(items) -> Any:
    """{path: leaf} pairs -> the nested dicts and lists they name (a dict
    whose keys are the ints 0..n-1 becomes a list)."""
    root: Dict = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            if sorted(out) != list(range(len(out))):
                raise ValueError(f"list indices {sorted(out)} have gaps")
            return [out[i] for i in range(len(out))]
        return out

    return listify(root)


def port_name(path: Path) -> str:
    """A reference leaf's path -> the port's parameter or buffer name."""
    *mods, leaf = path
    if len(mods) == 2 and mods[0] in _CROSS and isinstance(mods[1], int):
        mods = ["blocks", mods[1], mods[0]]
    if leaf in _STATS:
        attr = _STATS[leaf]
    else:
        attr = {"w": "weight", "gamma": "weight", "b": "bias",
                "beta": "bias"}[leaf]
    return ".".join(str(m) for m in mods) + "." + attr


def jax_path(name: str) -> Path:
    """A port parameter or buffer name -> the reference leaf's path."""
    *mods, attr = name.split(".")
    bn = "bn" in mods[-1]
    mods = [int(m) if m.isdigit() else m for m in mods]
    if len(mods) == 3 and mods[0] == "blocks" and mods[2] in _CROSS:
        mods = [mods[2], mods[1]]
    leaf = {"weight": "gamma" if bn else "w", "bias": "beta" if bn else "b",
            "running_mean": "mean", "running_var": "var"}[attr]
    return tuple(mods) + (leaf,)


def leaf_order(names: Sequence[str]) -> List[str]:
    """Port parameter names in the reference's ``jax.tree.leaves`` order."""
    return sorted(names, key=jax_path)


def _to_port(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 4:                       # HWIO -> OIHW
        a = np.transpose(a, (3, 2, 0, 1))
    elif a.ndim == 2:                     # [in, out] -> [out, in]
        a = a.T
    return _t(a)


def _to_reference(v) -> np.ndarray:
    a = _np(v)
    if a.ndim == 4:                       # OIHW -> HWIO
        a = np.transpose(a, (2, 3, 1, 0))
    elif a.ndim == 2:
        a = a.T
    return np.ascontiguousarray(a)


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference params (or a params-like pytree) -> {port parameter name:
    tensor}, in the reference's leaf order."""
    return {port_name(p): _to_port(a) for p, a in _walk(params)}


def params_to_jax(named: Dict[str, Any]) -> Dict[str, Any]:
    """{port parameter name: tensor or array} -> reference params."""
    return _build((jax_path(n), _to_reference(v)) for n, v in named.items())


def from_jax(params: Dict[str, Any], state: Dict[str, Any]
             ) -> Dict[str, torch.Tensor]:
    """Reference (params, state) of NumPy arrays -> the port's state_dict."""
    sd = params_from_jax(params)
    for path, a in _walk(state):
        name = port_name(path)
        sd[name] = _t(a)
        if path[-1] == "mean":
            sd[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    return sd


def to_jax(sd: Dict[str, torch.Tensor]
           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's state_dict -> reference (params, state) of NumPy
    arrays."""
    stats = {n for n in sd if n.endswith(tuple(_STATS.values()))}
    params = {n: v for n, v in sd.items()
              if n not in stats and not n.endswith(_SKIPPED)}
    state = _build((jax_path(n), _np(sd[n])) for n in stats)
    return params_to_jax(params), state


def _rank_slice(tree, rank: int):
    if isinstance(tree, dict):
        return {k: _rank_slice(v, rank) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rank_slice(v, rank) for v in tree]
    return np.asarray(tree)[rank]


def comm_from_jax(comm: Dict[str, Any], rank: int,
                  names: Sequence[str]) -> Dict[str, Any]:
    """Rank ``rank``'s slice of the reference's stacked comm state (NumPy
    arrays) -> the port's comm state for that rank.  ``names``: the port
    parameter names of the residual list and the Q factors, in their
    order (the model's registration order)."""
    res = params_from_jax(_rank_slice(comm["residual"], rank))
    if sorted(names) != sorted(res):
        raise ValueError("names do not match the comm state's leaves")
    out = {"residual": [res[n] for n in names]}
    if "q" in comm:
        leaves = list(res)                # reference leaf order
        qs = {leaves[int(k)]: _t(np.asarray(v)[rank])
              for k, v in comm["q"].items()}
        out["q"] = {n: qs[n] for n in names if n in qs}
    return out


def comm_to_jax(per_rank: Sequence[Dict[str, Any]],
                names: Sequence[str]) -> Dict[str, Any]:
    """Every rank's port comm state (tensors or arrays), in rank order ->
    the reference's stacked layout (NumPy arrays).  ``names``: the port
    parameter names of the residual list, in its order."""
    trees = [params_to_jax(dict(zip(names, c["residual"], strict=True)))
             for c in per_rank]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        if isinstance(leaves[0], list):
            return [stack(*ls) for ls in zip(*leaves)]
        return np.stack(leaves)

    out = {"residual": stack(*trees)}
    if "q" in per_rank[0]:
        index = {n: k for k, n in enumerate(leaf_order(names))}
        out["q"] = {f"{index[n]:03d}": np.stack(
            [_np(c["q"][n]) for c in per_rank])
            for n in per_rank[0]["q"]}
    return out


# -- the serving tree: what a weight bundle holds (publish/) -----------------


def _serving_tree(names: Sequence[str]) -> Tuple[Any, Any]:
    """The reference's ``(params, bn_state)`` tree over the port's names:
    each leaf is the port name it stands for (``num_batches_tracked``,
    which the reference lacks, left out)."""
    stats = [n for n in names if n.endswith(tuple(_STATS.values()))]
    params = [n for n in names
              if n not in set(stats) and not n.endswith(_SKIPPED)]
    return (_build((jax_path(n), n) for n in params),
            _build((jax_path(n), n) for n in stats))


def _render(node) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_render(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, list):
        return "[" + ", ".join(_render(v) for v in node) + "]"
    if isinstance(node, tuple):
        inner = ", ".join(_render(v) for v in node)
        return f"({inner},)" if len(node) == 1 else f"({inner})"
    return "*"


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` of a tree of dicts,
    lists and tuples, without JAX: dicts with their keys sorted and
    single-quoted, ``*`` for a leaf."""
    return f"PyTreeDef({_render(tree)})"


def _reference_shape(shape) -> Tuple[int, ...]:
    s = tuple(int(d) for d in shape)
    if len(s) == 4:                       # OIHW -> HWIO
        return (s[2], s[3], s[1], s[0])
    if len(s) == 2:
        return (s[1], s[0])
    return s


def serving_signature(sd: Dict[str, torch.Tensor]
                      ) -> Tuple[str, Tuple[Tuple[Tuple[int, ...], str], ...]]:
    """(treedef string, ((shape, dtype), ...)) of ``serving_leaves(sd)``,
    from the names, shapes and dtypes alone (nothing is copied): the
    reference engine's ``_key_fields["abstract"]``."""
    tree = _serving_tree(list(sd))
    return treedef_str(tree), tuple(
        (_reference_shape(sd[n].shape), str(sd[n].dtype).replace("torch.", ""))
        for _, n in _walk(tree))


def serving_leaves(sd: Dict[str, torch.Tensor]
                   ) -> Tuple[List[np.ndarray], str]:
    """The port's state_dict -> (leaves, treedef string) of the reference's
    ``jax.tree_util.tree_flatten((params, bn_state))``: NumPy arrays in
    ``jax.tree.leaves`` order, conv HWIO, linear [in, out]."""
    tree = _serving_tree(list(sd))
    return [_to_reference(sd[n]) for _, n in _walk(tree)], treedef_str(tree)


def state_dict_from_leaves(leaves: Sequence[np.ndarray],
                           template: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """``serving_leaves``' inverse: leaves in the reference's order and
    layout -> a state_dict with ``template``'s names, as CPU tensors; each
    ``num_batches_tracked`` (not in a bundle) is ``template``'s own
    tensor."""
    paths = [p for p, _ in _walk(_serving_tree(list(template)))]
    if len(leaves) != len(paths):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(paths)}")
    halves = [[(p[1:], a) for p, a in zip(paths, leaves) if p[0] == i]
              for i in (0, 1)]
    sd = from_jax(_build(halves[0]), _build(halves[1]))
    sd.update((n, v) for n, v in template.items() if n.endswith(_SKIPPED))
    return sd
