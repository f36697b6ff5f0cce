"""Models of the port (counterpart of ray_tpu/models/).

`get_model(name, device=..., seed=..., **config_overrides)` builds a
registry entry, as the reference's does; every entry takes the
port's `device=` (default "cuda") and `seed=`.
"""
from .clip import CLIP, CLIPConfig, contrastive_loss
from .convert import (clip_params_from_flax, gpt2_params_from_flax,
                      llama_params_from_flax, mixtral_params_from_flax,
                      mlp_params_from_flax, resnet_params_from_flax,
                      vit_params_from_flax)
from .gpt2 import GPT2, GPT2Config
from .llama import Llama, LlamaConfig
from .mixtral import Mixtral, MixtralConfig
from .mlp import MLP, MLPConfig, ResNetLite
from .vit import ViT, ViTConfig


def _factory(model_cls, preset):
    def build(device="cuda", seed=0, **kw):
        return model_cls(preset(**kw), device=device, seed=seed)
    return build


_REGISTRY = {
    "llama3-8b": _factory(Llama, LlamaConfig.llama3_8b),
    "llama3-1b": _factory(Llama, LlamaConfig.llama3_1b),
    "llama-debug": _factory(Llama, LlamaConfig.debug),
    "gpt2": _factory(GPT2, GPT2Config.small),
    "gpt2-medium": _factory(GPT2, GPT2Config.medium),
    "gpt2-large": _factory(GPT2, GPT2Config.large),
    "gpt2-debug": _factory(GPT2, GPT2Config.debug),
    "mixtral-8x7b": _factory(Mixtral, MixtralConfig.mixtral_8x7b),
    "mixtral-debug": _factory(Mixtral, MixtralConfig.debug),
    "vit-base": _factory(ViT, ViTConfig.base),
    "vit-debug": _factory(ViT, ViTConfig.debug),
    "clip-debug": _factory(CLIP, CLIPConfig.debug),
    "resnet-lite": ResNetLite,
}


def get_model(name: str, **kw):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


def register_model(name: str, factory) -> None:
    _REGISTRY[name] = factory


__all__ = ["Llama", "LlamaConfig", "GPT2", "GPT2Config", "Mixtral",
           "MixtralConfig", "ViT", "ViTConfig", "CLIP", "CLIPConfig",
           "contrastive_loss", "MLP", "MLPConfig", "ResNetLite",
           "get_model", "register_model", "llama_params_from_flax",
           "mixtral_params_from_flax", "gpt2_params_from_flax",
           "vit_params_from_flax", "clip_params_from_flax",
           "mlp_params_from_flax", "resnet_params_from_flax"]
