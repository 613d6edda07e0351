"""Weights from a flax model into the port's modules.

The port's modules are named after the flax modules they stand for, so a
state-dict key is the flax path of the same weight with ``/`` read as
``.``, two renames aside: a leaf ``kernel`` or ``embedding`` becomes
``weight``, and a block ``block_L`` lives in the ``blocks`` list as
``blocks.L``. Each leaf changes layout as torch's modules hold it:

- conv ``kernel`` [kh, kw, in, out] (HWIO) -> [out, in, kh, kw] (OIHW);
- Dense ``kernel`` [in, out] -> [out, in];
- DenseGeneral ``kernel`` of three axes: the input axes lead and the
  output axes trail, so [D, H, hd] (``q``, ``k``, ``v``, ``query``,
  ``key``, ``value``) reads as [D, H*hd] and [H, hd, D] (``o``,
  ``out``) as [H*hd, D], each then transposed; its [H, hd] ``bias`` is
  flattened;
- every other leaf (norm ``scale`` and ``bias``, BatchNorm ``mean`` and
  ``var``, ``pos_embed``) keeps its shape.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_OUT_PROJECTIONS = ("o", "out")


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (name,))
        else:
            yield path + (name,), value


def _key(path: Tuple[str, ...]) -> str:
    *modules, leaf = path
    modules = [re.sub(r"^block_(\d+)$", r"blocks.\1", m) for m in modules]
    leaf = "weight" if leaf in ("kernel", "embedding") else leaf
    return ".".join(modules + [leaf])


def _layout(path: Tuple[str, ...], x: torch.Tensor) -> torch.Tensor:
    leaf = path[-1]
    if leaf == "kernel" and x.dim() == 4:
        return x.permute(3, 2, 0, 1)
    if leaf == "kernel" and x.dim() == 3:
        if path[-2] in _OUT_PROJECTIONS:
            return x.reshape(-1, x.shape[-1]).T
        return x.reshape(x.shape[0], -1).T
    if leaf == "kernel" and x.dim() == 2:
        return x.T
    if leaf == "bias" and x.dim() == 2:
        return x.reshape(-1)
    return x


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax parameter tree -> the state dict of the port's module, fp32.

    ``tree`` is ``variables["params"]`` (or a gradient tree of the same
    shape) as nested dicts of arrays, or the whole ``variables`` dict, in
    which case its ``batch_stats`` (BatchNorm running averages) are
    carried too."""
    if "params" in tree:
        trees = [tree["params"], tree.get("batch_stats", {})]
    else:
        trees = [tree]
    out = {}
    for t in trees:
        for path, value in _leaves(t):
            x = torch.from_numpy(np.array(value, dtype=np.float32))
            out[_key(path)] = _layout(path, x).contiguous()
    return out
