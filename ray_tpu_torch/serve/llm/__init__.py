"""ray_tpu_torch.serve.llm — LLM serving on the paged continuous-batching
engine (counterpart of ray_tpu/serve/llm/__init__.py).

`LLMServer` takes the same request body as the JAX one. The deployment
binding (`build_llm_deployment`), request deadlines and prefix caching
need the serve control plane and wait for a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ...util.device import DeviceLike
from .engine import LLMEngine, LLMEngineConfig


class LLMServer:
    """A server over one LLMEngine.

    `model_factory` is a zero-arg callable returning (model, state):
    a ray_tpu_torch Llama-family module and a state_dict to load into it
    (None when the module already holds its weights). It is a factory
    so the weights are made or loaded where the server runs.
    """

    def __init__(self, model_factory, engine_config: Optional[dict] = None,
                 tokenizer: Optional[Any] = None, *,
                 device: DeviceLike = "cuda", seed: int = 0):
        model, state = model_factory()
        cfg = LLMEngineConfig(**dict(engine_config or {}))
        self.engine = LLMEngine(model, state, cfg, device=device, seed=seed)
        self.tokenizer = tokenizer

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
        rid = self.engine.submit(
            self._encode(body["prompt"]), body.get("max_tokens"),
            float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            stop_token_ids=body.get("stop_token_ids"))
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
