"""OpenAI-compatible serving surface over the LLM engine (counterpart of
ray_tpu/serve/llm/openai_api.py).

`OpenAIServer` is an `LLMServer` whose body shape picks the API:

    {"prompt": ...}    -> completions
    {"messages": ...}  -> chat completions

Streaming follows the OpenAI contract: `"stream": true` returns chunks
(for chat a leading {"delta": {"role": "assistant"}} chunk, then content
deltas, then a final chunk carrying finish_reason, then "[DONE]").
`stop` accepts a string or a list of strings/ids; single-token stop
strings also stop generation inside the engine, and every stop string is
enforced on the decoded text (so multi-token sequences work too, and a
streamed tail that could still grow into a stop match is held back).
Requests may carry `n` choices, `logprobs` (with an engine built with
logprobs=True), `presence_penalty`, `frequency_penalty`, `logit_bias`
and guided output (`guided_choice`, `guided_regex`, `guided_json`).
Invalid requests come back as OpenAI error objects.

`build_openai_deployment` makes it a serve deployment under "/v1".
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Tuple

from ...util.device import DeviceLike
from ..context import get_request_deadline
from ..deployment import Application
from . import LLMServer, build_llm_deployment

_req_ids = itertools.count()

# SentencePiece word-boundary marker (U+2581 LOWER ONE EIGHTH BLOCK)
_SP_SPACE = "▁"


def _token_strings(tokenizer, vocab_size: int) -> List[str]:
    """Per-token appended text for guided-regex compilation.

    Prefers tokenizer PIECES (convert_ids_to_tokens) with the
    SentencePiece `▁` word-boundary marker mapped to a literal space:
    `decode([i])` strips the marker, so "model" and "▁model" both
    decoded to "model" and space-crossing guided regexes compiled
    against the wrong per-token text. Pieces without the marker (and
    tokenizers without a piece API) keep the decode([i]) byte-level
    approximation — byte-level BPEs encode spaces as other markers
    (Ġ, Ċ) that only their decoder maps correctly."""
    convert = getattr(tokenizer, "convert_ids_to_tokens", None)
    pieces: List[Optional[str]] = [None] * vocab_size
    if convert is not None:
        try:
            got = convert(list(range(vocab_size)))
            if got is not None and len(got) == vocab_size:
                pieces = list(got)
        except Exception:
            pass
    out = []
    for i in range(vocab_size):
        p = pieces[i]
        if isinstance(p, str) and _SP_SPACE in p:
            out.append(p.replace(_SP_SPACE, " "))
        else:
            out.append(tokenizer.decode([i]))
    return out


class OpenAIServer(LLMServer):
    """LLMServer speaking the OpenAI REST schema."""

    def __init__(self, model_factory, engine_config: Optional[dict] = None,
                 tokenizer: Optional[Any] = None,
                 cached_prefixes: Optional[list] = None,
                 model_name: str = "ray-tpu-llm", *,
                 device: DeviceLike = "cuda", seed: int = 0):
        super().__init__(model_factory, engine_config, tokenizer,
                         cached_prefixes=cached_prefixes, device=device,
                         seed=seed)
        self._token_strings = None
        self._fsm_cache: Dict[Any, Any] = {}
        self.model_name = model_name

    # ---- request plumbing -------------------------------------------------
    def _sampling(self, body: Dict[str, Any], prompt_len: int
                  ) -> Tuple[Dict[str, Any], List[str], int]:
        """(engine submit kwargs, host-side stop strings, effective max
        new tokens after the engine's seq-budget clamp)."""
        stop = body.get("stop") or []
        if isinstance(stop, (str, int)):
            stop = [stop]
        stop_ids: List[int] = []
        stop_strings: List[str] = []
        for s in stop:
            if isinstance(s, int):
                stop_ids.append(s)
                continue
            stop_strings.append(s)
            if self.tokenizer is not None:
                ids = self.tokenizer.encode(s)
                if len(ids) == 1:
                    # single-token stops can end generation on-engine;
                    # longer ones rely on the host-side text match
                    stop_ids.append(ids[0])
        requested = body.get("max_tokens")
        cfg = self.engine.cfg
        effective = min(requested or cfg.max_new_tokens_default,
                        max(cfg.max_seq_len - prompt_len, 0))
        kwargs = dict(
            max_new_tokens=requested,
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            stop_token_ids=stop_ids or None,
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            logit_bias={int(k): float(v) for k, v in
                        (body.get("logit_bias") or {}).items()} or None)
        fsm = self._guided_fsm(body)
        if fsm is not None:
            kwargs["guided_fsm"] = fsm
        return kwargs, stop_strings, effective

    def _guided_fsm(self, body: Dict[str, Any]):
        """vLLM-style guided output: `guided_choice` (list of strings)
        or `guided_regex` (pattern over the detokenized output) compile
        to a serve.llm.guided.TokenFSM using this server's tokenizer."""
        choice = body.get("guided_choice")
        regex = body.get("guided_regex")
        schema = body.get("guided_json")
        if sum(x is not None for x in (choice, regex, schema)) > 1:
            raise ValueError("use guided_choice OR guided_regex OR "
                             "guided_json, not several")
        if schema is not None:
            if isinstance(schema, str):  # vLLM also accepts encoded
                import json as _json
                try:
                    schema = _json.loads(schema)
                except ValueError as e:
                    raise ValueError(f"guided_json is not valid JSON: "
                                     f"{e}") from e
            from .guided import json_schema_to_regex
            regex = json_schema_to_regex(schema)
        if choice is None and regex is None:
            return None
        if self.tokenizer is None:
            raise ValueError("guided output needs a tokenizer "
                             "(set tokenizer= on the deployment)")
        from .guided import GuidedSpec, compile_guided
        vs = int(self.engine.model.cfg.vocab_size)
        eos = self.engine.cfg.eos_token_id
        eos = vs if eos is None else int(eos)  # >=V: eos never unmasked
        key = (("choice", tuple(choice)) if choice
               else ("regex", regex)) + (vs, eos)
        fsm = self._fsm_cache.get(key)
        if fsm is not None:
            return fsm
        if choice:
            def tokenize(text):
                try:
                    return self.tokenizer.encode(
                        text, add_special_tokens=False)
                except TypeError:
                    return self.tokenizer.encode(text)
            fsm = compile_guided(GuidedSpec(choices=list(choice)),
                                 vocab_size=vs, eos_id=eos,
                                 tokenize=tokenize)
        else:
            if self._token_strings is None:
                self._token_strings = _token_strings(self.tokenizer, vs)
            fsm = compile_guided(GuidedSpec(regex=regex), vocab_size=vs,
                                 eos_id=eos,
                                 token_strings=self._token_strings)
        if len(self._fsm_cache) >= 64:  # bounded: drop oldest pattern
            self._fsm_cache.pop(next(iter(self._fsm_cache)))
        self._fsm_cache[key] = fsm
        return fsm

    def _chat_prompt(self, messages: List[Dict[str, str]]):
        tok = self.tokenizer
        if tok is not None and hasattr(tok, "apply_chat_template"):
            return tok.apply_chat_template(messages,
                                           add_generation_prompt=True)
        if tok is None:
            raise ValueError("chat API needs a tokenizer "
                             "(set tokenizer= on the deployment)")
        text = "".join(f"{m.get('role', 'user')}: {m.get('content', '')}\n"
                       for m in messages) + "assistant:"
        return tok.encode(text)

    def _decode_text(self, toks: List[int]) -> str:
        if self.tokenizer is not None:
            return self.tokenizer.decode(toks)
        return " ".join(str(t) for t in toks)

    @staticmethod
    def _apply_stops(text: str, stops: List[str]) -> Tuple[str, bool]:
        """Truncate at the earliest stop-string occurrence."""
        cut = None
        for s in stops:
            if not s:
                continue
            i = text.find(s)
            if i >= 0 and (cut is None or i < cut):
                cut = i
        return (text[:cut], True) if cut is not None else (text, False)

    def _finish_reason(self, n_out: int, effective: int, last_tok,
                       stop_ids, stopped_by_string: bool) -> str:
        if stopped_by_string:
            return "stop"
        if last_tok is not None and (
                last_tok == self.engine.cfg.eos_token_id
                or (stop_ids and last_tok in stop_ids)):
            return "stop"
        return "length" if n_out >= effective else "stop"

    def _collect(self, rid: str, stops: List[str]
                 ) -> Tuple[List[int], List, str, bool]:
        """Drain a request, aborting early when a stop string lands."""
        toks: List[int] = []
        lps: List = []
        text, by_string = "", False
        for tok, lp in self.engine.stream_detailed(rid):
            if by_string:
                continue  # draining to the end marker post-abort
            toks.append(tok)
            lps.append(lp)
            text, by_string = self._apply_stops(
                self._decode_text(toks), stops)
            if by_string:
                self.engine.abort(rid)
        return toks, lps, text, by_string

    # ---- the two APIs -----------------------------------------------------
    def __call__(self, body: Dict[str, Any]):
        try:
            if isinstance(body, dict) and "messages" in body:
                return self._chat(body)
            if isinstance(body, dict) and "prompt" in body:
                return self._completions(body)
        except ValueError as e:
            # invalid request (bad top_p, prompt too long for the
            # configured buckets, ...) -> OpenAI error object, not a 500
            err = {"error": {"message": str(e),
                             "type": "invalid_request_error"}}
            if isinstance(body, dict) and body.get("stream"):
                # a real generator: the replica's streaming path detects
                # generators, not arbitrary iterators
                def err_stream():
                    yield err
                    yield "[DONE]"
                return err_stream()
            return err
        return super().__call__(body)

    def _submit_n(self, n: int, suffix, prefix_id, sp) -> List[str]:
        """Submit all n choices; if the k-th submit raises (e.g. the
        pool can never admit it), abort the k-1 already-submitted
        request ids before re-raising — mirroring the _collect cleanup,
        so failed multi-choice calls never strand siblings on the
        engine."""
        rids: List[str] = []
        try:
            for _ in range(n):
                rids.append(self.engine.submit(
                    suffix, prefix_id=prefix_id,
                    deadline_ts=get_request_deadline(), **sp))
        except BaseException:
            for r in rids:
                try:
                    self.engine.abort(r)
                except Exception:
                    pass
            raise
        return rids

    @staticmethod
    def _n_choices(body: Dict[str, Any]) -> int:
        raw = body.get("n")
        n = 1 if raw is None else int(raw)
        if n < 1:
            raise ValueError("n must be >= 1")
        best_of = body.get("best_of")
        if best_of is not None and int(best_of) != n:
            raise ValueError("best_of != n is not supported")
        if body.get("stream") and n > 1:
            raise ValueError("streaming with n > 1 is not supported")
        return n

    def _completions(self, body: Dict[str, Any]):
        prompt = self._encode(body["prompt"])
        sp, stops, effective = self._sampling(body, len(prompt))
        suffix, prefix_id = self._match_prefix(prompt)
        n = self._n_choices(body)
        # all n submits enter the engine together and continuous-batch
        rids = self._submit_n(n, suffix, prefix_id, sp)
        oid = f"cmpl-{next(_req_ids)}"
        if body.get("stream"):
            return self._stream_events(
                rids[0], oid, "text_completion", stops, effective,
                sp["stop_token_ids"],
                content_chunk=lambda text: {"text": text},
                final_extra=lambda: {"text": ""})
        choices = []
        total_out = 0
        try:
            collected = [self._collect(rid, stops) for rid in rids]
        except BaseException:
            for r in rids:  # don't strand sibling choices on the engine
                try:
                    self.engine.abort(r)
                except Exception:
                    pass
            raise
        for idx, (toks, lps, text, by_string) in enumerate(collected):
            total_out += len(toks)
            logprobs = None
            if body.get("logprobs") and any(lp is not None
                                            for lp in lps):
                logprobs = {
                    "tokens": [self._decode_text([t]) for t in toks],
                    "token_logprobs": lps,
                    "top_logprobs": None, "text_offset": None}
            choices.append({
                "index": idx, "text": text,
                "finish_reason": self._finish_reason(
                    len(toks), effective, toks[-1] if toks else None,
                    sp["stop_token_ids"], by_string),
                "logprobs": logprobs})
        return {
            "id": oid, "object": "text_completion",
            "created": int(time.time()), "model": self.model_name,
            "choices": choices,
            "usage": {"prompt_tokens": len(prompt),
                      "completion_tokens": total_out,
                      "total_tokens": len(prompt) + total_out}}

    def _chat(self, body: Dict[str, Any]):
        prompt = self._chat_prompt(body["messages"])
        sp, stops, effective = self._sampling(body, len(prompt))
        suffix, prefix_id = self._match_prefix(prompt)
        n = self._n_choices(body)
        rids = self._submit_n(n, suffix, prefix_id, sp)
        rid = rids[0]
        oid = f"chatcmpl-{next(_req_ids)}"
        if body.get("stream"):
            return self._stream_events(
                rid, oid, "chat.completion.chunk", stops, effective,
                sp["stop_token_ids"],
                content_chunk=lambda text: {"delta": {"content": text}},
                final_extra=lambda: {"delta": {}},
                lead_chunk={"delta": {"role": "assistant"}})
        try:
            collected = [self._collect(r, stops) for r in rids]
        except BaseException:
            for r in rids:
                try:
                    self.engine.abort(r)
                except Exception:
                    pass
            raise
        choices = []
        total_out = 0
        for idx, (toks, _lps, text, by_string) in enumerate(collected):
            total_out += len(toks)
            choices.append({
                "index": idx,
                "message": {"role": "assistant", "content": text},
                "finish_reason": self._finish_reason(
                    len(toks), effective, toks[-1] if toks else None,
                    sp["stop_token_ids"], by_string)})
        return {
            "id": oid, "object": "chat.completion",
            "created": int(time.time()), "model": self.model_name,
            "choices": choices,
            "usage": {"prompt_tokens": len(prompt),
                      "completion_tokens": total_out,
                      "total_tokens": len(prompt) + total_out}}

    def _stream_events(self, rid: str, oid: str, obj: str,
                       stops: List[str], effective: int, stop_ids,
                       *, content_chunk, final_extra, lead_chunk=None):
        created = int(time.time())

        def wrap(choice: Dict[str, Any],
                 finish: Optional[str] = None) -> Dict[str, Any]:
            return {"id": oid, "object": obj, "created": created,
                    "model": self.model_name,
                    "choices": [{"index": 0, **choice,
                                 "finish_reason": finish}]}

        def holdback(text: str) -> int:
            """Length of the longest suffix of `text` that is a prefix
            of some stop string. That tail is withheld from the client:
            if the stop completes on a later token it must never have
            been sent (streamed and unary outputs would diverge)."""
            h = 0
            for s in stops:
                for k in range(min(len(s), len(text)), h, -1):
                    if text.endswith(s[:k]):
                        h = max(h, k)
                        break
            return h

        def gen():
            if lead_chunk is not None:
                yield wrap(lead_chunk)
            emitted = ""     # decoded text already sent to the client
            toks: List[int] = []
            last_tok = None
            by_string = False
            full = ""
            for tok, _lp in self.engine.stream_detailed(rid):
                if by_string:
                    continue  # draining to the end marker post-abort
                toks.append(tok)
                last_tok = tok
                full, by_string = self._apply_stops(
                    self._decode_text(toks), stops)
                # withhold any tail that could still grow into a stop
                # match (a suffix of the truncated text never reaches
                # back into already-emitted text: that prefix was itself
                # a stop prefix and was withheld on the earlier step)
                safe = full if by_string else full[:len(full)
                                                   - holdback(full)]
                delta = safe[len(emitted):]
                if delta:
                    emitted = safe
                    yield wrap(content_chunk(delta))
                if by_string:
                    # stop sequence landed: cut the engine request short
                    # but keep consuming so its stream closes cleanly
                    self.engine.abort(rid)
            if not by_string and len(full) > len(emitted):
                # stream ended (budget/EOS) with a withheld partial stop
                # match that can no longer complete: flush it
                yield wrap(content_chunk(full[len(emitted):]))
            yield wrap(final_extra(), finish=self._finish_reason(
                len(toks), effective, last_tok, stop_ids, by_string))
            yield "[DONE]"

        return gen()


def build_openai_deployment(model_factory, *, engine_config=None,
                            tokenizer=None, model_name="ray-tpu-llm",
                            name: str = "OpenAIServer",
                            num_replicas: int = 1,
                            route_prefix: str = "/v1",
                            cached_prefixes=None,
                            max_ongoing_requests: int = 64,
                            device: DeviceLike = "cuda",
                            ray_actor_options: Optional[dict] = None,
                            server_cls: type = OpenAIServer
                            ) -> Application:
    """An Application serving /v1/completions + /v1/chat/completions.

    cached_prefixes: shared prompt prefixes (e.g. the system prompt's
    token ids or text) prefilled once at startup; any request starting
    with one adopts its KV instead of re-prefilling (prefix caching).
    `device` and `ray_actor_options` as in `build_llm_deployment`: on
    CUDA each replica reserves one GPU unless options are given.
    `server_cls` may be a subclass of OpenAIServer."""
    engine_config = dict(engine_config or {})
    # the completions `logprobs` field needs the engine to fetch them
    engine_config.setdefault("logprobs", True)
    return build_llm_deployment(
        model_factory, engine_config=engine_config, tokenizer=tokenizer,
        name=name, num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        cached_prefixes=cached_prefixes,
        server_cls=server_cls,
        server_kwargs={"model_name": model_name},
        route_prefix=route_prefix, device=device,
        ray_actor_options=ray_actor_options)


__all__ = ["OpenAIServer", "build_openai_deployment"]
