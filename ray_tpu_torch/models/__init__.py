"""Models of the port (counterpart of ray_tpu/models/)."""
from .convert import llama_params_from_flax
from .llama import Llama, LlamaConfig

__all__ = ["Llama", "LlamaConfig", "llama_params_from_flax"]
