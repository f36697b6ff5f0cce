"""Guided (constrained) decoding: per-step vocab masks from an FSM
(counterpart of ray_tpu/serve/llm/guided.py, of which this is a copy:
the module is numpy only).

The automaton lives on the host and gives a (V,) bool mask of the
tokens allowed in its current state; the engine applies it on the
device before sampling (`logits = where(mask, logits, -inf)`).

Two constraint forms:

- ``choices``: the output must be exactly one of N token-id sequences
  (token-level trie; build from strings with `tokenize=`).
- ``regex``: the output's detokenized text must match the pattern.
  Internal engine: literals, ``.``, classes ``[a-z0-9]`` / ``[^...]``,
  groups, ``|``, ``* + ? {m} {m,} {m,n}`` — compiled to a Thompson NFA,
  subset-constructed to a DFA lazily.  Per DFA state the token-level
  transition over the whole vocab is computed ONCE as a vectorized
  numpy walk over the padded token-character matrix, then cached —
  per-step cost after warmup is a dict lookup + O(V) mask fetch.

EOS handling: the EOS token is allowed exactly when the automaton is in
an accepting state; any other token outside the language is masked out,
so a greedy or sampled decode can never leave the constraint.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["GuidedSpec", "TokenFSM", "compile_guided",
           "json_schema_to_regex"]


# ---------------------------------------------------------------- regex

class _NFA:
    """Thompson construction over byte/char codes 0..255 (we match on
    Python str chars via ord()<256; wider codepoints are matched by
    explicit literals only)."""

    def __init__(self):
        self.eps: List[List[int]] = []      # state -> eps targets
        self.edges: List[List[Tuple[np.ndarray, int]]] = []
        self.accept: int = -1

    def new_state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


def _charclass(expr: str, i: int) -> Tuple[np.ndarray, int]:
    """Parse a [...] class starting at expr[i] == '['; returns (mask256,
    next index)."""
    mask = np.zeros(256, dtype=bool)
    i += 1
    negate = i < len(expr) and expr[i] == "^"
    if negate:
        i += 1
    first = True
    while i < len(expr) and (expr[i] != "]" or first):
        first = False
        if expr[i] == "\\" and i + 1 < len(expr):
            nc = expr[i + 1]
            if nc in "dwsDWS":
                mask |= _escape_set(nc)
                i += 2
                continue
            # single-char escapes (\n, \t, ...) may still anchor a range
            lo = ord(_ESCAPE_CHARS.get(nc, nc))
            i += 2
        else:
            lo = ord(expr[i])
            i += 1
        if i + 1 < len(expr) and expr[i] == "-" and expr[i + 1] != "]":
            hi = ord(expr[i + 1])
            mask[lo:hi + 1] = True
            i += 2
        elif lo < 256:
            mask[lo] = True
    if i >= len(expr) or expr[i] != "]":
        raise ValueError(f"unterminated character class in {expr!r}")
    if negate:
        mask = ~mask
    return mask, i + 1


_ESCAPE_CHARS = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
                 "0": "\0", "a": "\a", "b": "\b"}


def _escape_set(c: str) -> np.ndarray:
    m = np.zeros(256, dtype=bool)
    if c == "d":
        m[ord("0"):ord("9") + 1] = True
    elif c == "w":
        m[ord("a"):ord("z") + 1] = True
        m[ord("A"):ord("Z") + 1] = True
        m[ord("0"):ord("9") + 1] = True
        m[ord("_")] = True
    elif c == "s":
        for ch in " \t\n\r\f\v":
            m[ord(ch)] = True
    elif c in "DWS":
        m = ~_escape_set(c.lower())
    elif c in _ESCAPE_CHARS:
        m[ord(_ESCAPE_CHARS[c])] = True
    else:
        if ord(c) < 256:
            m[ord(c)] = True
    return m


class _RegexParser:
    """Recursive-descent regex -> NFA fragment (start, end)."""

    def __init__(self, expr: str, nfa: _NFA):
        self.expr = expr
        self.i = 0
        self.nfa = nfa

    def parse(self) -> Tuple[int, int]:
        frag = self._alternation()
        if self.i != len(self.expr):
            raise ValueError(
                f"unexpected {self.expr[self.i]!r} at {self.i} "
                f"in regex {self.expr!r}")
        return frag

    def _alternation(self) -> Tuple[int, int]:
        frags = [self._concat()]
        while self.i < len(self.expr) and self.expr[self.i] == "|":
            self.i += 1
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for fs, fe in frags:
            self.nfa.eps[s].append(fs)
            self.nfa.eps[fe].append(e)
        return s, e

    def _concat(self) -> Tuple[int, int]:
        frags = []
        while self.i < len(self.expr) and self.expr[self.i] not in "|)":
            frags.append(self._repeat())
        if not frags:
            s = self.nfa.new_state()
            return s, s
        for (  _s1, e1), (s2, _e2) in zip(frags, frags[1:]):
            self.nfa.eps[e1].append(s2)
        return frags[0][0], frags[-1][1]

    def _repeat(self) -> Tuple[int, int]:
        frag = self._atom()
        first = True
        while self.i < len(self.expr) and self.expr[self.i] in "*+?{":
            c = self.expr[self.i]
            if c == "?" and not first:
                # lazy-quantifier marker (X+?, X{m,n}?): laziness picks
                # a different match, not a different LANGUAGE — for a
                # fullmatch automaton it is a no-op, NOT (X+)?
                self.i += 1
                continue
            first = False
            if c == "{":
                j = self.expr.index("}", self.i)
                body = self.expr[self.i + 1:j]
                if "," in body:
                    lo_s, hi_s = body.split(",", 1)
                    lo = int(lo_s or 0)
                    hi = int(hi_s) if hi_s else None
                else:
                    lo = hi = int(body)
                self.i = j + 1
                frag = self._repeat_range(frag, lo, hi)
            else:
                self.i += 1
                s, e = self.nfa.new_state(), self.nfa.new_state()
                fs, fe = frag
                self.nfa.eps[s].append(fs)
                self.nfa.eps[fe].append(e)
                if c in "*?":
                    self.nfa.eps[s].append(e)
                if c in "*+":
                    self.nfa.eps[fe].append(fs)
                frag = (s, e)
        return frag

    def _repeat_range(self, frag, lo: int, hi: Optional[int]):
        # expand {m,n} by cloning the sub-expression; clones share no
        # states so the NFA stays a DAG of fragments
        src_s, src_e = frag
        clones = []
        total = hi if hi is not None else max(lo, 1)
        for _ in range(total):
            clones.append(self._clone(src_s, src_e))
        s, e = self.nfa.new_state(), self.nfa.new_state()
        cur = s
        for idx, (cs, ce) in enumerate(clones):
            self.nfa.eps[cur].append(cs)
            # `cur` has completed exactly `idx` repetitions: exiting is
            # legal only once idx >= lo (idx+1 would accept m-1 reps)
            if idx >= lo:
                self.nfa.eps[cur].append(e)
            cur = ce
        self.nfa.eps[cur].append(e)
        if hi is None:  # {m,}: loop the final clone
            fs, fe = clones[-1]
            self.nfa.eps[fe].append(fs)
        return (s, e)

    def _clone(self, s: int, e: int) -> Tuple[int, int]:
        """Deep-copy the fragment reachable from s (up to e)."""
        mapping: Dict[int, int] = {}
        stack = [s]
        while stack:
            st = stack.pop()
            if st in mapping:
                continue
            mapping[st] = self.nfa.new_state()
            for t in self.nfa.eps[st]:
                if t not in mapping:
                    stack.append(t)
            for _m, t in self.nfa.edges[st]:
                if t not in mapping:
                    stack.append(t)
        for st, new in list(mapping.items()):
            self.nfa.eps[new] = [mapping[t] for t in self.nfa.eps[st]]
            self.nfa.edges[new] = [(m, mapping[t])
                                   for m, t in self.nfa.edges[st]]
        return mapping[s], mapping[e]

    def _atom(self) -> Tuple[int, int]:
        expr = self.expr
        c = expr[self.i]
        if c in "^$":
            # the automaton always fullmatches, so anchors are no-ops
            # (outlines/vLLM-style patterns commonly include them)
            self.i += 1
            st = self.nfa.new_state()
            return st, st
        if c == "(":
            self.i += 1
            frag = self._alternation()
            if self.i >= len(expr) or expr[self.i] != ")":
                raise ValueError(f"unbalanced ( in regex {expr!r}")
            self.i += 1
            return frag
        if c == "[":
            mask, self.i = _charclass(expr, self.i)
            return self._edge(mask)
        if c == ".":
            self.i += 1
            mask = np.ones(256, dtype=bool)
            return self._edge(mask)
        if c == "\\" and self.i + 1 < len(expr):
            self.i += 2
            return self._edge(_escape_set(expr[self.i - 1]))
        self.i += 1
        mask = np.zeros(256, dtype=bool)
        if ord(c) < 256:
            mask[ord(c)] = True
        return self._edge(mask)

    def _edge(self, mask: np.ndarray) -> Tuple[int, int]:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.edges[s].append((mask, e))
        return s, e


class _DFA:
    """Full subset construction (iterative worklist) with a dense char
    transition row per state (256-wide; -1 = dead)."""

    def __init__(self, nfa: _NFA, start: int, accept: int):
        self.nfa = nfa
        self.accept_nfa = accept
        self.states: Dict[frozenset, int] = {}
        self.trans: List[np.ndarray] = []
        self.accepting: List[bool] = []
        self.start = self._intern(self._closure({start}))
        work = [self.start]
        closures = {self.start: next(c for c, i in self.states.items()
                                     if i == self.start)}
        while work:
            sid = work.pop()
            closure = closures[sid]
            row = self.trans[sid]
            char_targets: List[Tuple[np.ndarray, int]] = []
            for s in closure:
                for mask, t in self.nfa.edges[s]:
                    char_targets.append((mask, t))
            if not char_targets:
                continue
            all_mask = np.zeros((len(char_targets), 256), dtype=bool)
            for k, (mask, _t) in enumerate(char_targets):
                all_mask[k] = mask
            # group chars by their target-set signature
            by_key: Dict[frozenset, List[int]] = {}
            for c in np.flatnonzero(all_mask.any(axis=0)):
                tgt = frozenset(t for k, (_m, t) in enumerate(char_targets)
                                if all_mask[k, c])
                by_key.setdefault(tgt, []).append(int(c))
            for tgt_key, chars in by_key.items():
                closure2 = self._closure(set(tgt_key))
                known = self.states.get(closure2)
                nid = self._intern(closure2)
                if known is None:
                    closures[nid] = closure2
                    work.append(nid)
                row[chars] = nid

    def _closure(self, states: set) -> frozenset:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for t in self.nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def _intern(self, closure: frozenset) -> int:
        sid = self.states.get(closure)
        if sid is not None:
            return sid
        sid = len(self.trans)
        self.states[closure] = sid
        self.trans.append(np.full(256, -1, dtype=np.int64))
        self.accepting.append(self.accept_nfa in closure)
        return sid


# ------------------------------------------------------------- token FSM

class GuidedSpec:
    """User-facing constraint: exactly one of `choices` (strings or
    token-id sequences), `regex` over the detokenized output, or
    `json_schema` (compiled to a regex via json_schema_to_regex — the
    output is canonical compact JSON matching the schema subset)."""

    def __init__(self, choices: Optional[Sequence] = None,
                 regex: Optional[str] = None,
                 json_schema: Optional[dict] = None):
        provided = sum(x is not None
                       for x in (choices, regex, json_schema))
        if provided != 1:
            raise ValueError("GuidedSpec needs exactly one of choices=, "
                             "regex=, or json_schema=")
        if json_schema is not None:
            regex = json_schema_to_regex(json_schema)
        self.choices = list(choices) if choices is not None else None
        self.regex = regex
        self.json_schema = json_schema

    def __repr__(self):
        if self.choices is not None:
            return f"GuidedSpec(choices={self.choices!r})"
        if self.json_schema is not None:
            return f"GuidedSpec(json_schema={self.json_schema!r})"
        return f"GuidedSpec(regex={self.regex!r})"


class TokenFSM:
    """Token-level automaton over a fixed vocab.

    API used by the engine (all host-side, O(V) per step after warmup):
      - ``start`` : initial state id
      - ``allowed(state)`` -> (V,) bool mask (incl. eos when accepting)
      - ``advance(state, token)`` -> next state id (-1 = dead)
      - ``is_accepting(state)``
      - ``is_complete(state)``: accepting AND no live continuation
    """

    def __init__(self, vocab_size: int, eos_id: int):
        self.vocab_size = vocab_size
        self.eos_id = eos_id
        self.start = 0

    # -- choice/trie construction

    @classmethod
    def from_choices(cls, seqs: Sequence[Sequence[int]], vocab_size: int,
                     eos_id: int) -> "TokenFSM":
        fsm = cls(vocab_size, eos_id)
        fsm._mode = "trie"
        # trie node: dict token -> node id; node 0 = root
        fsm._children: List[Dict[int, int]] = [{}]
        fsm._accept: List[bool] = [False]
        for seq in seqs:
            seq = [int(t) for t in seq]
            if not seq:
                fsm._accept[0] = True
                continue
            node = 0
            for tok in seq:
                nxt = fsm._children[node].get(tok)
                if nxt is None:
                    nxt = len(fsm._children)
                    fsm._children.append({})
                    fsm._accept.append(False)
                    fsm._children[node][tok] = nxt
                node = nxt
            fsm._accept[node] = True
        fsm._mask_cache: Dict[int, np.ndarray] = {}
        return fsm

    @classmethod
    def from_regex(cls, pattern: str, token_strings: Sequence[str],
                   eos_id: int) -> "TokenFSM":
        """token_strings[i] = the text token id i appends (the engine
        passes tokenizer.convert_ids_to_tokens-style strings; specials/
        unused ids may be None to exclude them)."""
        fsm = cls(len(token_strings), eos_id)
        fsm._mode = "regex"
        nfa = _NFA()
        parser = _RegexParser(pattern, nfa)
        s, e = parser.parse()
        nfa.accept = e
        fsm._dfa = _DFA(nfa, s, e)
        # padded char-code matrix (V, Lmax); -1 pads; unusable tokens
        # (None/empty/non-latin1) get length 0 and are always masked out
        lens = np.zeros(len(token_strings), dtype=np.int64)
        codes_list = []
        for ts in token_strings:
            if ts is None or ts == "" or any(ord(ch) > 255 for ch in ts):
                codes_list.append([])
            else:
                codes_list.append([ord(ch) for ch in ts])
                lens[len(codes_list) - 1] = len(ts)
        lmax = max((len(c) for c in codes_list), default=1) or 1
        mat = np.zeros((len(token_strings), lmax), dtype=np.int64)
        for v, codes in enumerate(codes_list):
            mat[v, :len(codes)] = codes
        fsm._tok_codes = mat
        fsm._tok_lens = lens
        # per-DFA-state caches: (allowed mask incl eos, end-state per tok)
        fsm._state_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        return fsm

    # -- shared API

    def allowed(self, state: int) -> np.ndarray:
        if state < 0:
            return np.zeros(self.vocab_size, dtype=bool)
        if self._mode == "trie":
            mask = self._mask_cache.get(state)
            if mask is None:
                mask = np.zeros(self.vocab_size, dtype=bool)
                for tok in self._children[state]:
                    if tok < self.vocab_size:
                        mask[tok] = True
                if self._accept[state] and self.eos_id < self.vocab_size:
                    mask[self.eos_id] = True
                self._mask_cache[state] = mask
            return mask
        mask, _ends = self._regex_state(state)
        return mask

    def advance(self, state: int, token: int) -> int:
        if state < 0:
            return -1
        if token == self.eos_id:
            return state if self.is_accepting(state) else -1
        if self._mode == "trie":
            return self._children[state].get(int(token), -1)
        _mask, ends = self._regex_state(state)
        return int(ends[token]) if 0 <= token < self.vocab_size else -1

    def is_accepting(self, state: int) -> bool:
        if state < 0:
            return False
        if self._mode == "trie":
            return self._accept[state]
        return self._dfa.accepting[state]

    def is_complete(self, state: int) -> bool:
        """Accepting with no way to continue — the engine force-stops."""
        if state < 0:
            return False
        mask = self.allowed(state)
        if self.eos_id < self.vocab_size:
            cont = mask.copy()
            cont[self.eos_id] = False
        else:
            cont = mask
        return self.is_accepting(state) and not cont.any()

    # -- regex internals

    def _regex_state(self, state: int) -> Tuple[np.ndarray, np.ndarray]:
        cached = self._state_cache.get(state)
        if cached is not None:
            return cached
        # vectorized walk of EVERY vocab token's chars through the DFA,
        # once per (visited) DFA state, then cached
        V, L = self._tok_codes.shape
        table = self._table()
        cur = np.full(V, state, dtype=np.int64)
        for col in range(L):
            live = (self._tok_lens > col) & (cur >= 0)
            if not live.any():
                break
            nxt = table[cur[live], self._tok_codes[live, col]]
            cur[live] = nxt
        ends = np.where(self._tok_lens > 0, cur, -1)
        mask = ends >= 0
        if self.eos_id < V:
            mask = mask.copy()
            mask[self.eos_id] = self._dfa.accepting[state]
            ends[self.eos_id] = state if self._dfa.accepting[state] else -1
        result = (mask, ends)
        self._state_cache[state] = result
        return result

    def _table(self) -> np.ndarray:
        """Dense (n_states, 256) DFA transition table, built once."""
        tbl = getattr(self, "_table_cache", None)
        if tbl is None or len(tbl) != len(self._dfa.trans):
            tbl = np.stack(self._dfa.trans) if self._dfa.trans else \
                np.full((1, 256), -1, dtype=np.int64)
            self._table_cache = tbl
        return tbl


def compile_guided(spec: GuidedSpec, *, vocab_size: int, eos_id: int,
                   tokenize: Optional[Callable[[str], List[int]]] = None,
                   token_strings: Optional[Sequence[str]] = None
                   ) -> TokenFSM:
    """Build the TokenFSM for a spec.

    choices: items may be token-id sequences already, or strings (then
    `tokenize` is required).  regex: requires `token_strings`."""
    if spec.choices is not None:
        seqs = []
        for ch in spec.choices:
            if isinstance(ch, str):
                if tokenize is None:
                    raise ValueError(
                        "string choices need tokenize= to map them to "
                        "token ids")
                seqs.append(tokenize(ch))
            else:
                seqs.append(list(ch))
        return TokenFSM.from_choices(seqs, vocab_size, eos_id)
    if token_strings is None:
        raise ValueError("regex constraints need token_strings= "
                         "(text appended by each token id)")
    return TokenFSM.from_regex(spec.regex, token_strings, eos_id)


# ---------------------------------------------------------- JSON schema

_REGEX_META = set(".[]{}()*+?|^$\\")


def _rx_literal(text: str) -> str:
    """Escape `text` for the guided regex engine (fullmatch subset)."""
    out = []
    for ch in text:
        if ch in _REGEX_META:
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


# canonical compact JSON value regexes (guided output is canonical:
# no whitespace, fixed key order — the standard shape for guided_json)
_RX_STRING = r'"[^"\\]*"'          # simple strings: no escapes/quotes
_RX_INTEGER = r"-?(0|[1-9][0-9]{0,15})"
_RX_NUMBER = _RX_INTEGER + r"(\.[0-9]{1,8})?"
_RX_BOOL = r"(true|false)"
_RX_NULL = r"null"


def json_schema_to_regex(schema: dict, *, _depth: int = 0) -> str:
    """Compile a practical JSON-schema subset to the guided regex
    language (reference: the guided_json mode of the vLLM/outlines-style
    serving API — schema-constrained decoding).

    Supported: type object (properties in declaration order; non-required
    trailing properties become optional), string (+ enum, maxLength via
    simple strings), integer, number, boolean, null, array (items,
    minItems/maxItems up to 8), enum of strings/numbers, const.
    The output language is CANONICAL compact JSON: no whitespace, keys
    in schema order — every string in the language parses with
    json.loads and validates against the schema subset."""
    if not isinstance(schema, dict):
        raise ValueError(
            f"json schema must be an object, got {type(schema).__name__}")
    if _depth > 16:
        raise ValueError("json schema nesting too deep (>16)")
    if "const" in schema:
        import json as _json
        return _rx_literal(_json.dumps(schema["const"],
                                       separators=(",", ":")))
    if "enum" in schema:
        import json as _json
        if not schema["enum"]:
            raise ValueError("enum must be non-empty (unsatisfiable)")
        opts = [_rx_literal(_json.dumps(v, separators=(",", ":")))
                for v in schema["enum"]]
        return "(" + "|".join(opts) + ")"
    t = schema.get("type")
    if t == "string":
        lo = schema.get("minLength")
        hi = schema.get("maxLength")
        if lo is None and hi is None:
            return _RX_STRING
        lo = int(lo or 0)
        hi = int(hi if hi is not None else max(lo, 64))
        if lo > hi:
            raise ValueError("minLength > maxLength")
        return '"' + r'[^"\\]' + "{%d,%d}" % (lo, hi) + '"'

    if t == "integer":
        return _RX_INTEGER
    if t == "number":
        return _RX_NUMBER
    if t == "boolean":
        return _RX_BOOL
    if t == "null":
        return _RX_NULL
    if t == "array":
        item = json_schema_to_regex(schema.get("items", {"type": "null"}),
                                    _depth=_depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", 8))
        if hi > 8 or lo > hi:
            raise ValueError("array bounds: need minItems <= maxItems "
                             "<= 8 for guided arrays")
        item_g = f"({item})"
        if hi == 0:
            return r"\[\]"
        more = f"(,{item_g}){{{max(lo - 1, 0)},{hi - 1}}}" \
            if hi > 1 else ""
        body = f"{item_g}{more}"
        if lo == 0:
            return r"\[" + f"({body})?" + r"\]"
        return r"\[" + body + r"\]"
    if t == "object" or "properties" in schema:
        props = schema.get("properties", {})
        # JSON-Schema semantics: a missing `required` key means NO
        # property is required (the old default of all-of-them silently
        # inverted that and forced optional fields into every output)
        required = set(schema.get("required", ()))
        parts = []
        import json as _json
        for key, sub in props.items():
            val = json_schema_to_regex(sub, _depth=_depth + 1)
            # keys are JSON-encoded like const/enum values, so quotes,
            # control chars, and non-latin1 keys stay valid JSON (or
            # fail loudly in the regex engine, never silently)
            pair = f'{_rx_literal(_json.dumps(key))}:({val})'
            parts.append((pair, key in required))
        if not parts:
            return r"\{\}"
        # canonical order; optional properties must be a trailing run
        # AFTER at least one required property, so every optional pair
        # carries its own leading comma and the grammar stays regular
        if not parts[0][1] and len(parts) > 1:
            raise ValueError(
                "guided JSON objects need the first property required "
                "(optional properties form a trailing run)")
        seen_optional = False
        body = ""
        for idx, (pair, req) in enumerate(parts):
            lead = "," if idx > 0 else ""
            if req:
                if seen_optional:
                    raise ValueError(
                        "required properties must precede optional ones "
                        "(canonical guided JSON)")
                body += lead + pair
            else:
                seen_optional = True
                body += f"({lead}{pair})?"
        return r"\{" + body + r"\}"
    raise ValueError(f"unsupported json schema: {schema!r}")
