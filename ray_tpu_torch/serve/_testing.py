"""Model factories, a tokenizer and a stream reader for the serve tests.

The runtime pickles a function or class of an importable module by
reference into its worker processes, so what a replica runs in the
tests lives here, in the port, where importing it loads neither JAX nor
the JAX package. The weights come as plain data (numpy arrays made by
the caller) and the model runs on the CPU.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


class CodepointTok:
    """Token id t is the character chr(0x4E00 + t), so decode is
    one-to-one: a reply's text gives back its token ids."""

    BASE = 0x4E00

    def encode(self, text):
        return [ord(c) - self.BASE for c in text]

    def decode(self, ids):
        return "".join(chr(self.BASE + int(t)) for t in ids)


def llama_factory(widths: Dict[str, Any],
                  state: Optional[Dict[str, np.ndarray]] = None):
    """A zero-arg model factory's body (bind it with functools.partial):
    an fp32 Llama of `widths` on the CPU and `state` as tensors (None:
    the module keeps its own seeded weights)."""
    from ..models import Llama, LlamaConfig
    model = Llama(LlamaConfig(**widths, dtype=torch.float32,
                              param_dtype=torch.float32), device="cpu")
    if state is None:
        return model, None
    return model, {k: torch.as_tensor(np.asarray(v))
                   for k, v in state.items()}


def drain(stream, timeout_s: float) -> list:
    """Every item of a streaming response, read on a thread: a
    `DeploymentResponseGenerator` has no timeout of its own, so a stuck
    replica fails the caller after `timeout_s` instead of hanging it."""
    out, errors = [], []

    def run():
        try:
            out.extend(stream)
        except BaseException as e:  # noqa: BLE001  re-raised below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise TimeoutError(f"the stream did not end within {timeout_s} s")
    if errors:
        raise errors[0]
    return out
