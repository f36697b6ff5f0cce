"""ray_tpu_torch.serve.llm — LLM serving on the continuous-batching engine
(counterpart of ray_tpu/serve/llm/__init__.py).

`LLMServer` takes the same request body as the JAX one, the same
`cached_prefixes` and dynamic `register_prefix`, and passes the request
deadline of `serve.context` to the engine; `OpenAIServer`
(`openai_api.py`) speaks the OpenAI completions and chat schema over it.
`build_llm_deployment` and `build_openai_deployment` make either a
serve deployment: `serve.run(build_openai_deployment(factory))` runs
each server in a replica actor of the serve control plane, and
`serve.http_proxy.start_proxy` puts it behind HTTP.

Deliberate difference: both take `device=` (default "cuda") and
`ray_actor_options=`. On a CUDA device with no options given, each
replica reserves `{"num_gpus": 1}`: the runtime hides the cards from a
worker granted none, so the engine could not reach one. `device="cpu"`
reserves none.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...exceptions import EngineWedgedError
from ...util.device import DeviceLike
from ..context import get_request_deadline
from ..deployment import Application, deployment_decorator
from .engine import LLMEngine, LLMEngineConfig
from .guided import (GuidedSpec, TokenFSM, compile_guided,
                     json_schema_to_regex)


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
        self._prefix_lock = threading.Lock()
        self._prefix_keys: Dict[str, int] = {}   # affinity key -> pid
        self._prefix_inflight: set = set()       # keys mid-registration
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
        with self._prefix_lock:
            prefixes = list(self._cached_prefixes)
        for ids, pid in prefixes:
            if prompt.size > ids.size and np.array_equal(prompt[:ids.size],
                                                         ids):
                return prompt[ids.size:], pid
        return prompt, None

    def register_prefix(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Register a shared prefix after startup. body: {"prefix": str |
        [token ids], "key": affinity key}. Idempotent per key; a key
        whose registration is still running answers {"pending": True}
        instead of taking a second engine prefix slot. Needs
        engine_config max_prefixes > 0."""
        key = body.get("key") or ""
        ids = np.asarray(self._encode(body["prefix"]), np.int32).reshape(-1)
        with self._prefix_lock:
            pid = self._prefix_keys.get(key) if key else None
            if pid is not None:
                return {"key": key, "prefix_id": int(pid),
                        "prefix_tokens": int(ids.size)}
            if key in self._prefix_inflight:
                return {"key": key, "prefix_id": -1, "pending": True}
            self._prefix_inflight.add(key)
        try:
            # the prefill may take a while: never under the lock, which
            # the request path's _match_prefix takes
            pid = self.engine.register_prefix(ids)
        finally:
            with self._prefix_lock:
                self._prefix_inflight.discard(key)
        with self._prefix_lock:
            if key:
                self._prefix_keys[key] = pid
            self._cached_prefixes.append((ids, pid))
            self._cached_prefixes.sort(key=lambda t: -t[0].size)
        return {"key": key, "prefix_id": int(pid),
                "prefix_tokens": int(ids.size)}

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
        "stop_token_ids": [ids], "stream": bool}. The request deadline
        set in `serve.context`, if any, goes to the engine."""
        prompt, prefix_id = self._match_prefix(self._encode(body["prompt"]))
        rid = self.engine.submit(
            prompt, body.get("max_tokens"),
            float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            stop_token_ids=body.get("stop_token_ids"), prefix_id=prefix_id,
            deadline_ts=get_request_deadline())
        if body.get("stream"):
            def gen():
                for tok in self.engine.stream(rid):
                    yield self._decode_tok(tok)
            return gen()
        toks = list(self.engine.stream(rid))
        if self.tokenizer is not None:
            return {"text": self.tokenizer.decode(toks), "tokens": toks}
        return {"tokens": toks}

    def generate(self, body: Dict[str, Any]):
        return self(body)

    def stats(self, _body=None) -> Dict[str, Any]:
        return self.engine.get_stats()

    def autoscale_metrics(self) -> Dict[str, Any]:
        """The engine's signals an autoscaler keys on: queue depth,
        active slots, KV-page utilisation, TTFT and TPOT p50, and the
        prefix-cache savings."""
        s = self.engine.get_stats()
        out: Dict[str, Any] = {
            "queue_depth": float(s.get("waiting", 0) or 0),
            "active_slots": float(s.get("active", 0) or 0),
            "prefix_tokens_saved": float(
                s.get("prefix_tokens_saved", 0) or 0),
        }
        kv = s.get("kv_pages") or {}
        if kv.get("total"):
            out["kv_util"] = kv["in_use"] / max(kv["total"], 1)
        ttft = s.get("ttft_breakdown_p50_ms") or {}
        if ttft.get("total_ms") is not None:
            out["ttft_p50_ms"] = float(ttft["total_ms"])
        if s.get("tpot_p50_ms") is not None:
            out["tpot_ms"] = float(s["tpot_p50_ms"])
        return out

    def check_health(self) -> None:
        """Raises when the engine loop died, or EngineWedgedError when
        the watchdog declared the engine wedged."""
        if not self.engine._loop_thread.is_alive():
            raise RuntimeError("engine loop died")
        if self.engine.wedged:
            raise EngineWedgedError(
                "wedged: engine loop made no forward progress past "
                "its watchdog window; replica must be replaced")

    def shutdown(self) -> None:
        self.engine.shutdown()


def build_llm_deployment(model_factory, *, engine_config=None,
                         tokenizer=None, name: str = "LLMServer",
                         num_replicas: int = 1,
                         max_ongoing_requests: int = 32,
                         cached_prefixes=None,
                         server_cls=None, server_kwargs=None,
                         route_prefix: str = "/",
                         device: DeviceLike = "cuda",
                         ray_actor_options: Optional[dict] = None
                         ) -> Application:
    """Build a ready-to-run LLM serving app:
    `serve.run(build_llm_deployment(factory))`. `server_cls` swaps the
    deployment class (e.g. openai_api.OpenAIServer); `cached_prefixes`
    registers shared prompt prefixes for engine prefix caching.
    `model_factory` runs in each replica. `device` is the engine's;
    `ray_actor_options` defaults to one GPU on a CUDA device, none on
    the CPU."""
    if ray_actor_options is None:
        # a worker granted no card runs with the cards hidden
        ray_actor_options = ({"num_gpus": 1}
                             if torch.device(device).type == "cuda" else {})
    dep = deployment_decorator(
        server_cls or LLMServer, name=name, num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        route_prefix=route_prefix,
        ray_actor_options=dict(ray_actor_options))
    return dep.bind(model_factory, engine_config=engine_config,
                    tokenizer=tokenizer,
                    cached_prefixes=cached_prefixes, device=device,
                    **(server_kwargs or {}))


def __getattr__(name):
    if name in ("OpenAIServer", "build_openai_deployment"):
        from . import openai_api
        return getattr(openai_api, name)
    raise AttributeError(name)


__all__ = ["LLMEngine", "LLMEngineConfig", "LLMServer", "GuidedSpec",
           "TokenFSM", "compile_guided", "json_schema_to_regex",
           "build_llm_deployment", "OpenAIServer",
           "build_openai_deployment"]
