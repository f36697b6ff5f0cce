"""Carry JAX/flax Llama weights over to the port's `Llama`.

`llama_params_from_flax(tree)` takes the flax parameter tree of
`ray_tpu.models.llama.Llama` as nested dicts of numpy arrays (e.g.
`jax.tree.map(np.asarray, params)`) and returns a state_dict for
`ray_tpu_torch.models.llama.Llama`:

  dense `<path>/kernel` [in, out]   -> `<path>.weight` [out, in]
  `token_embed/embedding` [V, d]    -> `token_embed.weight` [V, d]
  `lm_head/kernel` [d, V]           -> `lm_head.weight` [V, d]
  norm vectors (`attn_norm`, ...)   -> the same names, unchanged
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, Any]:
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def llama_params_from_flax(tree: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    state = {}
    for path, arr in _flatten(tree).items():
        a = np.asarray(arr)
        leaf = path[-1]
        if leaf == "kernel":
            name = ".".join(path[:-1]) + ".weight"
            a = a.T                                 # [in, out] -> [out, in]
        elif leaf == "embedding":
            name = ".".join(path[:-1]) + ".weight"
        elif leaf.endswith("norm") and a.ndim == 1:
            name = ".".join(path)
        else:
            raise ValueError(f"unmapped flax parameter {'/'.join(path)} "
                             f"{a.shape}")
        state[name] = torch.from_numpy(np.array(a, order="C"))
    return state
