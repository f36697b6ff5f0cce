"""Entry point of the port (counterpart of `__graft_entry__.entry()`).

`entry(device="cuda")` returns (forward, example_args) for the flagship
Llama-family decoder: `forward(params, tokens)` gives the logits of the
model under `params` (a name -> tensor dict, its state_dict), and
example_args holds the model's own parameters and a (2, 128) token
batch from numpy's RandomState(0). The multi-GPU dry run waits for the
parallelism slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from .models import Llama, LlamaConfig
from .util.device import DeviceLike, resolve_device


def flagship_config() -> LlamaConfig:
    """The flagship widths: Llama-3's architecture at d 512, 4 layers,
    8/4 heads, vocab 2048."""
    return LlamaConfig(vocab_size=2048, d_model=512, n_layers=4, n_heads=8,
                       n_kv_heads=4, d_ff=1408, max_seq_len=512)


def entry(device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    cfg = flagship_config()
    model = Llama(cfg, device=dev, seed=0)
    params = dict(model.state_dict())
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)).to(dev)

    def forward(params, tokens):
        logits, _ = functional_call(model, params, (tokens,))
        return logits

    return forward, (params, tokens)


__all__ = ["entry", "flagship_config"]
