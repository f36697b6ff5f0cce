"""Faults planted under the timed path: the tests that see `correct` come
out false use them at debug widths, and `calibrate.py` reads them at a
cell's own size. Each is a context manager that patches the program or
the feed and puts it back.

- `serve_token_altered`: the third token of every request replaced by
  the next id where the engine emits it;
- `serve_half_slots`: every other row of each decode step keeps its
  last token, half of the batch left out of the step;
- `train_state_unchanged`: the optimizer's step returns the state as
  it was;
- `train_half_batch`: half of each row's tokens left out of the loss,
  the mean taken over the rest.
"""
import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    try:
        yield
    finally:
        setattr(owner, name, old)


def serve_token_altered():
    from ray_tpu_torch.serve.llm.engine import LLMEngine
    emit = LLMEngine._emit

    def altered(self, req, tok, logp=None):
        if req.generated == 2:
            tok = (tok + 1) % self.model.cfg.vocab_size
        return emit(self, req, tok, logp)

    return _patched(LLMEngine, "_emit", altered)


def serve_half_slots():
    import torch

    from ray_tpu_torch.serve.llm.engine import LLMEngine
    decode = LLMEngine._decode

    def half(self, mask, *a, **k):
        nxt, lps, lengths = decode(self, mask, *a, **k)
        rows = torch.arange(nxt.shape[0], device=nxt.device) % 2 == 1
        return torch.where(rows, self._last_tokens, nxt), lps, lengths

    return _patched(LLMEngine, "_decode", half)


def train_state_unchanged():
    from ray_tpu_torch.train import optim

    def unchanged(self, closure=None):
        self.count += 1

    return _patched(optim.AdamW, "step", unchanged)


def train_half_batch():
    from harness import traffic
    plain = traffic.lm_batches

    def halved(mix, seed, vocab):
        for b in plain(mix, seed, vocab):
            mask = np.ones((mix["batch"], mix["seq_len"]), np.float32)
            mask[:, mix["seq_len"] // 2:] = 0.0
            yield dict(b, loss_mask=mask)

    return _patched(traffic, "lm_batches", halved)


SERVE = {"altered": serve_token_altered, "half": serve_half_slots}
TRAIN = {"half": train_half_batch}
