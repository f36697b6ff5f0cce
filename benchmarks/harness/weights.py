"""Seeded weights, made on the device in a few large calls.

A model's weights are split into groups (the embedding, each layer's
matrices, each layer's norms, the head) by its plain reference
(`reference/<family>.py`, `weight_groups`), each group with the one type
its tensors are stored in. Each group is one normal draw over all its
elements from a generator seeded by (seed, group index), in that type,
then scaled per tensor. The program and the reference
call the same function, so either side can make any group again on its
own, bit for bit, and the reference takes nothing the program made.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# (name, shape, std, mean): a tensor of the group is mean + std * N(0, 1)
Entry = Tuple[str, Tuple[int, ...], float, float]
# (group name, storage type, entries)
Group = Tuple[str, torch.dtype, List[Entry]]


def group_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63)


def make_group(entries: List[Entry], seed: int, index: int,
               dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The group's tensors, views of one flat buffer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, index))
    total = sum(_numel(shape) for _, shape, _, _ in entries)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    out, off = {}, 0
    for name, shape, std, mean in entries:
        n = _numel(shape)
        view = flat[off:off + n].view(shape)
        view.mul_(std)
        if mean:
            view.add_(mean)
        out[name] = view
        off += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def group_index(groups: List[Group], name: str) -> int:
    for i, (gname, _, _) in enumerate(groups):
        if gname == name:
            return i
    raise KeyError(name)


def make_named(groups: List[Group], name: str, seed: int,
               device) -> Dict[str, torch.Tensor]:
    i = group_index(groups, name)
    _, dtype, entries = groups[i]
    return make_group(entries, seed, i, dtype, device)


@torch.no_grad()
def load_into(model: torch.nn.Module, groups: List[Group], seed: int,
              device) -> None:
    """Fill every parameter of `model` from the groups. Every parameter
    has to be named by exactly one entry, in the group's type."""
    params = dict(model.named_parameters())
    seen = set()
    for index, (gname, dtype, entries) in enumerate(groups):
        for name, *_ in entries:
            if params[name].dtype != dtype:
                raise TypeError(f"{name} is {params[name].dtype}; weight "
                                f"group {gname} makes {dtype}")
        made = make_group(entries, seed, index, dtype, device)
        for name, t in made.items():
            params[name].copy_(t)
            seen.add(name)
        del made
    missing = set(params) - seen
    if missing:
        raise KeyError(f"parameters no weight group names: {sorted(missing)}")
