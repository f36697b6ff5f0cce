"""Carry JAX/flax weights over to the port's models.

Each `<family>_params_from_flax(tree)` takes the flax parameter tree of
the reference's model as nested dicts of numpy arrays (e.g.
`jax.tree.map(np.asarray, params)`) and returns a state_dict of the
port's model of that family. The port keeps flax's names, joined by
".", so the mapping is by leaf:

  dense `<path>/kernel` [in, out]        -> `<path>.weight` [out, in]
  conv `<path>/kernel` [kh, kw, in, out] -> `<path>.weight` [out, in, kh, kw]
  dense or conv `<path>/bias`            -> `<path>.bias`
  `<path>/embedding` [V, d]              -> `<path>.weight` [V, d]
  int8 `<path>/kernel_q` [in, out]       -> `<path>.kernel_q` [out, in]
  the family's own leaves (norm vectors, `scale`s, `cls_token`,
  `pos_embed`, stacked expert kernels, ...)  -> the same name, unchanged

A leaf the family does not have raises ValueError.
"""
from __future__ import annotations

from typing import Any, Dict, FrozenSet, Mapping

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


def _from_flax(tree: Mapping[str, Any], keep: FrozenSet[str],
               keep_suffix: tuple = ()) -> Dict[str, torch.Tensor]:
    """The leaf rules above; `keep` names (or `keep_suffix` ends) the
    family's leaves that carry over unchanged."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    state = {}
    for path, arr in _flatten(tree).items():
        a = np.asarray(arr)
        leaf, base = path[-1], ".".join(path[:-1])
        if leaf == "kernel" and a.ndim == 2:
            name, a = base + ".weight", a.T
        elif leaf == "kernel" and a.ndim == 4:
            name, a = base + ".weight", a.transpose(3, 2, 0, 1)
        elif leaf == "kernel_q" and a.ndim == 2:
            name, a = base + ".kernel_q", a.T
        elif leaf == "embedding" and a.ndim == 2:
            name = base + ".weight"
        elif leaf in keep or leaf.endswith(keep_suffix):
            name = ".".join(path)
        else:
            raise ValueError(f"unmapped flax parameter {'/'.join(path)} "
                             f"{a.shape}")
        state[name] = torch.from_numpy(np.array(a, order="C"))
    return state


_LLAMA = frozenset({"attn_norm", "mlp_norm", "final_norm"})


def llama_params_from_flax(tree: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """Llama, fp or int8 (`quantize_llama_params`' tree: `kernel_q` and
    `scale`)."""
    return _from_flax(tree, _LLAMA | {"scale"})


def mixtral_params_from_flax(tree: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """Mixtral: the Llama leaves, `router_kernel` (d, E) and the stacked
    `experts_{gate,up,down}_kernel`, kept in flax's layout."""
    return _from_flax(tree, _LLAMA | {
        "router_kernel", "experts_gate_kernel", "experts_up_kernel",
        "experts_down_kernel"})


def gpt2_params_from_flax(tree: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """GPT-2: `wte`/`wpe` embeddings, fused `qkv` with bias, the
    LayerNorms' `ln_*_scale` / `ln_*_bias`."""
    return _from_flax(tree, frozenset({"bias"}),
                      keep_suffix=("_scale", "_bias"))


_VISION = frozenset({"bias", "cls_token", "pos_embed"})


def vit_params_from_flax(tree: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """ViT: the patch conv, `cls_token`, `pos_embed`, LayerNorms."""
    return _from_flax(tree, _VISION, keep_suffix=("_scale", "_bias"))


def clip_params_from_flax(tree: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """CLIP: the vision trunk's leaves, `text_pos_embed`,
    `logit_scale`, the text LayerNorms."""
    return _from_flax(tree, _VISION | {"text_pos_embed", "logit_scale"},
                      keep_suffix=("_scale", "_bias"))


def mlp_params_from_flax(tree: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """MLP: dense layers only."""
    return _from_flax(tree, frozenset({"bias"}))


def resnet_params_from_flax(tree: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """ResNetLite: convs and the head, GroupNorm `scale` and `bias`."""
    return _from_flax(tree, frozenset({"bias", "scale"}))


def pipelined_lm_params_from_flax(tree: Mapping[str, Any]
                                  ) -> Dict[str, Any]:
    """The reference's PipelinedLM params ({"embed": {"embedding"},
    "stages": LlamaBlock leaves stacked (pp, L, ...), "final_norm"}) ->
    the port's (parallel/pipeline_train.py): the embedding table, the
    stage stacks under the port's block names (a kernel's last two dims
    transposed to (out, in)) and the final norm."""
    stages = {}
    for path, arr in _flatten(tree["stages"]).items():
        a = np.asarray(arr)
        if path[-1] == "kernel":
            name, a = ".".join(path[:-1]) + ".weight", np.swapaxes(a, -1, -2)
        elif path[-1] in _LLAMA:
            name = ".".join(path)
        else:
            raise ValueError(f"unmapped flax stage leaf {'/'.join(path)}")
        stages[name] = torch.from_numpy(np.array(a, order="C"))
    return {"embed": torch.from_numpy(np.array(
                tree["embed"]["embedding"], order="C")),
            "stages": stages,
            "final_norm": torch.from_numpy(np.array(tree["final_norm"]))}


def lora_from_flax(lora: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's LoRA tree (`init_lora`'s {"rank", "alpha",
    "adapters"}, adapters as numpy, None where a kernel has no adapter)
    -> the port's (train/lora.py): keyed by the weight's name, A
    (in, rank) -> A (rank, in) and B (rank, out) -> B (out, rank)."""
    adapters = {}
    for path, arr in _flatten(lora["adapters"]).items():
        if arr is None:             # an untargeted position
            continue
        a = np.asarray(arr)
        if len(path) < 3 or path[-2] != "kernel" or path[-1] not in "AB" \
                or a.ndim != 2:
            raise ValueError(f"unmapped flax LoRA leaf {'/'.join(path)} "
                             f"{a.shape}")
        name = ".".join(path[:-2]) + ".weight"
        adapters.setdefault(name, {})[path[-1]] = torch.from_numpy(
            np.array(a.T, order="C"))
    return {"rank": int(lora["rank"]), "alpha": float(lora["alpha"]),
            "adapters": adapters}
