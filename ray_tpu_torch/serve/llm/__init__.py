"""ray_tpu_torch.serve.llm — LLM serving on the continuous-batching engine
(counterpart of ray_tpu/serve/llm/__init__.py).

`LLMServer` takes the same request body as the JAX one, and the same
`cached_prefixes`. The deployment binding (`build_llm_deployment`),
request deadlines and the dynamic `register_prefix` hook need the serve
control plane and wait for a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ...util.device import DeviceLike
from .engine import LLMEngine, LLMEngineConfig


class LLMServer:
    """A server over one LLMEngine.

    `model_factory` is a zero-arg callable returning (model, state):
    a ray_tpu_torch Llama-family module and a state_dict to load into it
    (None when the module already holds its weights). It is a factory
    so the weights are made or loaded where the server runs.

    `cached_prefixes`: shared prompt prefixes (token lists, or strings
    with a tokenizer) registered on the engine at startup; a request
    whose prompt starts with one adopts its KV instead of prefilling it.
    Matching is by tokens: a miss pays the normal prefill.
    """

    def __init__(self, model_factory, engine_config: Optional[dict] = None,
                 tokenizer: Optional[Any] = None,
                 cached_prefixes: Optional[list] = None, *,
                 device: DeviceLike = "cuda", seed: int = 0):
        model, state = model_factory()
        engine_config = dict(engine_config or {})
        if cached_prefixes:
            engine_config.setdefault("max_prefixes", len(cached_prefixes))
        cfg = LLMEngineConfig(**engine_config)
        self.engine = LLMEngine(model, state, cfg, device=device, seed=seed)
        self.tokenizer = tokenizer
        self._cached_prefixes = []      # (tokens, pid), longest first
        for p in cached_prefixes or []:
            ids = np.asarray(self._encode(p), np.int32).reshape(-1)
            self._cached_prefixes.append((ids, self.engine.register_prefix(
                ids)))
        self._cached_prefixes.sort(key=lambda t: -t[0].size)

    def _match_prefix(self, prompt):
        """(submit_prompt, prefix_id): strip the longest registered
        prefix the prompt starts with (and is longer than)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        for ids, pid in self._cached_prefixes:
            if prompt.size > ids.size and np.array_equal(prompt[:ids.size],
                                                         ids):
                return prompt[ids.size:], pid
        return prompt, None

    def _encode(self, prompt):
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError(
                    "text prompt but no tokenizer configured; pass token "
                    "ids or set tokenizer=")
            return self.tokenizer.encode(prompt)
        return prompt

    def _decode_tok(self, tok: int):
        if self.tokenizer is not None:
            return self.tokenizer.decode([tok])
        return tok

    def __call__(self, body: Dict[str, Any]):
        """Unary or streaming generate. body: {"prompt": [ids] | str,
        "max_tokens": int, "temperature": float, "top_p": float,
        "stop_token_ids": [ids], "stream": bool}."""
        prompt, prefix_id = self._match_prefix(self._encode(body["prompt"]))
        rid = self.engine.submit(
            prompt, body.get("max_tokens"),
            float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            stop_token_ids=body.get("stop_token_ids"), prefix_id=prefix_id)
        if body.get("stream"):
            def gen():
                for tok in self.engine.stream(rid):
                    yield self._decode_tok(tok)
            return gen()
        toks = list(self.engine.stream(rid))
        if self.tokenizer is not None:
            return {"text": self.tokenizer.decode(toks), "tokens": toks}
        return {"tokens": toks}

    def stats(self) -> Dict[str, Any]:
        return self.engine.get_stats()

    def shutdown(self) -> None:
        self.engine.shutdown()


__all__ = ["LLMEngine", "LLMEngineConfig", "LLMServer"]
