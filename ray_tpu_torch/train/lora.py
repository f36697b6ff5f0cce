"""LoRA adapters over a frozen base (counterpart of
ray_tpu/train/lora.py).

As in the reference, adapters are a small tree of their own beside the
frozen base parameters, not wrapped modules: for every targeted 2-D
`Dense` weight the tree holds a pair {"A", "B"} and `merge_lora` gives
`weight + (alpha / rank) * delta` as a pure function, so gradients flow
into the adapters only and the optimizer's state is O(adapter).

Layout. The port's `Dense.weight` is (out, in), the nn.Linear layout
(flax's kernel is (in, out)). The adapters follow it, as PEFT's
`lora_A` / `lora_B` do: A is (rank, in) and B is (out, rank), and the
delta is B @ A, the transpose of the reference's A (in, rank) @ B
(rank, out). `models.convert.lora_from_flax` transposes the
reference's pairs into this layout.

Names. `lora["adapters"]` maps the weight's parameter name (e.g.
`layer_0.attention.q_proj.weight`) to its pair; a weight with no
adapter has no entry (the reference keeps a None leaf there).

Typical use:
    lora = init_lora(model, seed, rank=8)
    state, step = make_lora_train_step(model, tx)(example_batch, lora)
    state, metrics = step(state, batch)
    merged = merge_lora(model, {**lora, "adapters":
                                unflatten_adapters(state.params)})
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, \
    Union

import torch
from torch import nn
from torch.func import functional_call

from .optim import global_norm
from .spmd import TrainState, next_token_loss

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                   "gate_proj", "up_proj", "down_proj",
                   "qkv", "proj", "fc1", "fc2")

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Sequence[str] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _named(params: Params) -> Dict[str, torch.Tensor]:
    """name -> tensor of a module's parameters or of a state_dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _is_target(name: str, t: torch.Tensor, targets: Sequence[str]) -> bool:
    """The reference's rule (leaf `kernel`, 2-D, parent in targets) on the
    port's names: leaf `weight`, 2-D, owning module named in targets.
    Embeddings, int8 `kernel_q` and stacked 3-D expert kernels never
    match."""
    parts = name.split(".")
    return (len(parts) >= 2 and parts[-1] == "weight"
            and parts[-2] in targets and t.ndim == 2)


def init_lora(params: Params, rng: Union[int, torch.Generator] = 0,
              rank: int = 8, alpha: float = 16.0,
              targets: Sequence[str] = DEFAULT_TARGETS) -> Dict[str, Any]:
    """Adapters for every targeted weight of `params` (a module or a
    state_dict): A ~ N(0, 1) / rank and B = 0, both fp32 on the weight's
    device whatever the weight's type, so the merged model starts
    exactly at the base. `rng` is a seed or a `torch.Generator` on that
    device. Raises ValueError when nothing matches."""
    cfg = LoraConfig(rank=rank, alpha=alpha, targets=tuple(targets))
    named = _named(params)
    adapters = {}
    for name, w in named.items():
        if not _is_target(name, w, cfg.targets):
            continue
        gen = rng
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=w.device).manual_seed(int(rng))
            rng = gen
        d_out, d_in = w.shape
        a = torch.randn((cfg.rank, d_in), dtype=torch.float32,
                        device=w.device, generator=gen) / cfg.rank
        b = torch.zeros((d_out, cfg.rank), dtype=torch.float32,
                        device=w.device)
        adapters[name] = {"A": a, "B": b}
    if not adapters:
        raise ValueError(f"no LoRA targets matched; targets={cfg.targets}")
    return {"rank": cfg.rank, "alpha": cfg.alpha, "adapters": adapters}


def lora_delta(pair: Mapping[str, torch.Tensor], scaling: float,
               dtype: torch.dtype) -> torch.Tensor:
    """(B @ A) * scaling in fp32, rounded to `dtype` (the reference's
    `(A @ B * scaling).astype(p.dtype)`, transposed)."""
    return ((pair["B"] @ pair["A"]) * scaling).to(dtype)


def merge_lora(params: Params, lora: Mapping[str, Any]
               ) -> Dict[str, torch.Tensor]:
    """name -> tensor of `params` with every adapted weight replaced by
    weight + (scaling * B @ A) rounded to the weight's type (so a bf16
    base merges in bf16). Pure and differentiable in the adapters; the
    entries without an adapter are the base's own tensors."""
    scaling = lora["alpha"] / lora["rank"]
    named = _named(params)
    out = dict(named)
    for name, pair in lora["adapters"].items():
        if name not in named:
            raise KeyError(f"adapter {name!r} has no weight in params")
        p = named[name]
        out[name] = p + lora_delta(pair, scaling, p.dtype)
    return out


def lora_param_count(lora: Mapping[str, Any]) -> int:
    return sum(t.numel() for pair in lora["adapters"].values()
               for t in pair.values())


def flatten_adapters(adapters: Mapping[str, Mapping[str, torch.Tensor]]
                     ) -> Dict[str, torch.Tensor]:
    """{weight: {"A", "B"}} -> {"weight/A": A, "weight/B": B}, the flat
    names an optimizer and a TrainState take."""
    return {f"{name}/{k}": t for name, pair in adapters.items()
            for k, t in pair.items()}


def unflatten_adapters(flat: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, t in flat.items():
        name, k = key.rsplit("/", 1)
        out.setdefault(name, {})[k] = t
    return out


def frozen_base(params: Params) -> Dict[str, torch.Tensor]:
    """The base as detached tensors: no gradient reaches it."""
    return {k: v.detach() for k, v in _named(params).items()}


def make_lora_train_step(model: nn.Module, tx,
                         base_params: Optional[Params] = None, *,
                         loss_fn: Optional[Callable] = None) -> Callable:
    """Like `make_train_step`, but only the adapters train: the base
    (`base_params`, default the model's own parameters) is closed over
    detached and never written, and the optimizer (`tx`, a factory from
    `make_optimizer`) and the TrainState hold the adapters alone, by the
    flat names of `flatten_adapters`.

    Returns init_fn; `init_fn(example_batch, lora)` gives (TrainState
    over the adapters, step); `step(state, batch)` returns (state,
    metrics) with the loss function's metrics and `grad_norm`, the
    global norm of the adapters' gradients before clipping. The forward
    runs the model through `torch.func.functional_call` on the merged
    weights. `loss_fn(apply, batch) -> (loss, metrics)`, where
    `apply(inputs)` is that forward, defaults to `next_token_loss`."""
    loss_fn = loss_fn or next_token_loss
    base = frozen_base(model if base_params is None else base_params)

    def init_fn(example_batch, lora) -> Tuple[TrainState, Callable]:
        del example_batch  # shapes come from the batch at call time
        meta = {"rank": lora["rank"], "alpha": lora["alpha"]}
        flat = {k: v.detach().clone().requires_grad_(True)
                for k, v in flatten_adapters(lora["adapters"]).items()}
        state = TrainState(step=0, params=flat,
                           opt_state=tx(list(flat.items())))

        def step(state: TrainState, batch):
            params = list(state.params.values())
            for p in params:
                p.grad = None
            merged = merge_lora(base, {
                **meta, "adapters": unflatten_adapters(state.params)})

            def apply(inputs):
                return functional_call(model, merged, (inputs,))

            loss, metrics = loss_fn(apply, batch)
            loss.backward()
            del merged
            metrics = dict(metrics)
            metrics["grad_norm"] = global_norm(p.grad for p in params)
            state.opt_state.step()
            for p in params:
                p.grad = None
            state.step += 1
            return state, metrics

        return state, step

    return init_fn


__all__ = ["LoraConfig", "init_lora", "merge_lora", "lora_param_count",
           "make_lora_train_step", "DEFAULT_TARGETS", "flatten_adapters",
           "unflatten_adapters", "lora_delta"]
