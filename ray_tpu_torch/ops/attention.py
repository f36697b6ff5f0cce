"""Attention (counterpart of ray_tpu/ops/attention.py).

`multi_head_attention(impl=)` takes the reference's four routes; "auto"
reads `RAY_TPU_ATTN_IMPL` first, as the reference's `_resolve_impl`
does, and any name outside `ATTN_IMPLS` raises ValueError:
  * "auto" routes by device and shape, with no crossover length: on a
    CUDA tensor it takes `kernels.flash_attention` (K1 forward, K2a/K2b
    backward) when there are no segment ids, the mask needs no offset
    (`not causal or Sq == Sk`: the kernels compare absolute indices) and
    `flash_takes` holds (a head dim the kernels are built for, fp32 or
    bf16, q, k and v of one type); every other call, and every CPU
    tensor, takes "xla";
  * "xla" is the plain einsum path on every device (`einsum_attention`:
    fp32 scores, offset causal mask, GQA, segment masks);
  * "pallas" calls `kernels.flash_attention` unconditionally: its plain
    version on a CPU tensor (the reference's interpret mode), K1/K2a/K2b
    or a raise on a CUDA tensor, never the einsum path. It raises on
    segment ids, which the reference drops silently;
  * "dpa" is `F.scaled_dot_product_attention`, an A/B baseline no path
    takes unless asked; like the reference's it refuses segment ids and
    Sq != Sk.
The cached paths share one tail, `_attend_cached`, so the paged and
contiguous caches cannot drift apart numerically.

`sequence_parallel_attention` is the attention of a sequence-sharded
train step (a published sp mesh, parallel/sharding.py): this rank's
query chunk against the whole K/V gathered over sp, causal. The
kernels compare absolute indices, so the chunk's call is split in two:
its keys before the chunk (no mask) and its own chunk (Sq == Sk, the
plain causal mask), merged by the rows' logsumexp
(`_SplitPrefixAttention`: K1 twice, K2a/K2b twice in the backward,
once each for chunk 0). "xla" takes the einsum path over the keys up
to the chunk's end (its offset mask is the chunk's own); "dpa" has no
logsumexp to merge by and raises.

`paged_cached_attention` reads `RAY_TPU_PAGED_ATTN_IMPL` ("auto",
"gather" or "pallas") on every call, as the reference does:
  * fresh prefill (every sequence starts empty) -> `multi_head_attention`
    over the new tokens with the model's `impl`, unless the knob says
    "gather";
  * single-token decode -> K3, `kernels.paged_decode_attention`: under
    "auto" on a CUDA tensor where `paged_decode_takes` holds (a head dim
    K3 is built for, at most `MAX_REP` query heads per kv head, fp32 or
    bf16, q and both pools of one type); under "pallas" always (the
    plain version on a CPU tensor, K3 or a raise on a CUDA one);
  * any other call, and everything under "gather" -> the page-gather
    path below.
Each kernel wrapper takes its plain PyTorch version for a CPU tensor
and launches its CUDA kernel for a CUDA tensor; nothing falls back from
a kernel to a plain version. While a profiler capture runs on the
calling thread (observability/profiler.py), the "pallas" route counts
each call by shape, `k1.launch:B,S,Hq,Hkv,D,causal` (S the query
length), after it returns.

JAX's functional caches become in-place updates here: the KV pools and
contiguous caches are written with `index_copy_` / indexed assignment
(the counterpart of the JAX engine donating its cache buffers), and the
returned cache entry holds the same tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..observability.profiler import capturing, count
from ..util import knobs
from .kernels import flash_attention as _fa
from .kernels.flash_attention import HEAD_DIMS as FLASH_HEAD_DIMS
from .kernels.flash_attention import flash_attention
from .kernels.paged_attention import HEAD_DIMS as DECODE_HEAD_DIMS
from .kernels.paged_attention import MAX_REP, paged_decode_attention

_F32_MIN = torch.finfo(torch.float32).min
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
ATTN_IMPLS = ("auto", "xla", "dpa", "pallas")
PAGED_ATTN_IMPLS = ("auto", "gather", "pallas")


def check_attn_impl(impl: str) -> str:
    """`impl` when it names a route of `multi_head_attention`, else
    ValueError (a model config's `attn_impl` is checked by this)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={impl!r}; valid: "
                         f"{', '.join(ATTN_IMPLS)}")
    return impl


def _knob_impl(name: str, valid) -> str:
    value = knobs.get_str(name)
    if value not in valid:
        raise ValueError(f"{name}={value!r}; valid: {', '.join(valid)}")
    return value


def paged_attn_impl() -> str:
    """The paged cache's route, read from RAY_TPU_PAGED_ATTN_IMPL on
    every call (module docstring)."""
    return _knob_impl("RAY_TPU_PAGED_ATTN_IMPL", PAGED_ATTN_IMPLS)


def causal_attention_mask(seq_len: int, dtype: torch.dtype = torch.bool,
                          device=None) -> torch.Tensor:
    """(seq_len, seq_len) lower-triangular mask: 1 (True) where query i
    may attend key j <= i."""
    return torch.tril(torch.ones((seq_len, seq_len), dtype=dtype,
                                 device=device))


def _repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: kv head h serves query heads h*rep .. h*rep+rep-1."""
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


def flash_takes(head_dim: int, q_dtype: torch.dtype, k_dtype: torch.dtype,
                v_dtype: torch.dtype) -> bool:
    """Whether K1 (and K2a/K2b) is built for this head dim and these
    types: the shape-and-type half of the flash route."""
    return (head_dim in FLASH_HEAD_DIMS and q_dtype in _KERNEL_DTYPES
            and k_dtype == q_dtype and v_dtype == q_dtype)


def paged_decode_takes(head_dim: int, n_heads: int, n_kv_heads: int,
                       q_dtype: torch.dtype, k_dtype: torch.dtype,
                       v_dtype: torch.dtype) -> bool:
    """Whether K3 is built for this head dim, GQA group and these types
    (q's and the two pools'): the shape-and-type half of the decode
    route."""
    return (head_dim in DECODE_HEAD_DIMS and n_heads % n_kv_heads == 0
            and n_heads // n_kv_heads <= MAX_REP
            and q_dtype in _KERNEL_DTYPES
            and k_dtype == q_dtype and v_dtype == q_dtype)


def _takes_flash(q, k, v, causal, segment_ids) -> bool:
    return (q.is_cuda and segment_ids is None
            and (not causal or q.shape[1] == k.shape[1])
            and flash_takes(q.shape[-1], q.dtype, k.dtype, v.dtype))


def resolve_impl(impl: str, q, k, v, causal: bool, segment_ids) -> str:
    """The route `multi_head_attention` takes: "auto" reads
    RAY_TPU_ATTN_IMPL, and a pinned name stands; "auto" left after that
    becomes "pallas" where K1 takes the call, else "xla"."""
    if check_attn_impl(impl) == "auto":
        impl = _knob_impl("RAY_TPU_ATTN_IMPL", ATTN_IMPLS)
    if impl != "auto":
        return impl
    return "pallas" if _takes_flash(q, k, v, causal, segment_ids) else "xla"


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         segment_ids: Optional[torch.Tensor] = None,
                         impl: str = "auto",
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) with Hq % Hkv == 0.
    Returns (B, Sq, Hq, D). `impl` pins a route (module docstring).
    Scores in fp32 on "xla"; with Sk != Sq under causal its mask is
    offset so the last query sees every key, where "pallas" compares
    absolute indices, as the reference's kernel does."""
    impl = resolve_impl(impl, q, k, v, causal, segment_ids)
    if impl == "pallas":
        if segment_ids is not None:
            raise ValueError("impl='pallas' takes no segment_ids (the "
                             "kernel has no segment mask); use impl='xla'")
        out = flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=causal, scale=scale)
        if capturing():
            b, s, hq, d = q.shape
            count(f"k1.launch:{b},{s},{hq},{k.shape[2]},{d},{int(causal)}")
        return out
    if impl == "dpa":
        if segment_ids is not None or q.shape[1] != k.shape[1]:
            raise ValueError(
                "impl='dpa' supports only self-attention without "
                "segment_ids; use impl='xla' for packed/cached shapes")
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, scale=scale, enable_gqa=True)
        return out.transpose(1, 2)
    return einsum_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                            scale=scale)


def _merge_parts(parts, dtype):
    """(out, lse) of attention over the union of the parts' keys, from
    each part's (out, lse): fp32 weights exp(lse_part - lse)."""
    if len(parts) == 1:
        return parts[0]
    (out_a, lse_a), (out_b, lse_b) = parts
    lse = torch.logaddexp(lse_a, lse_b)
    b, c, hq, _ = out_a.shape

    def weight(part):
        return torch.exp(part - lse).view(b, hq, c).transpose(1, 2)[..., None]

    out = out_a.float() * weight(lse_a) + out_b.float() * weight(lse_b)
    return out.to(dtype), lse


def _key_parts(k, v, index, c):
    """[(k, v, causal, start)] of chunk `index`: the keys before it
    (none for chunk 0), then its own, each contiguous for the kernels."""
    lo = index * c
    parts = [] if lo == 0 else [
        (k[:, :lo].contiguous(), v[:, :lo].contiguous(), False, 0)]
    parts.append((k[:, lo:lo + c].contiguous(), v[:, lo:lo + c].contiguous(),
                  True, lo))
    return parts


class _SplitPrefixAttention(torch.autograd.Function):
    """Causal attention of query chunk `index` (B, c, Hq, D) against the
    whole sequence's K/V (B, S, Hkv, D): K1 on the prefix (non-causal)
    and on the diagonal block (causal), merged by lse. The backward runs
    K2a/K2b on each part with the merged lse and delta: a part's P
    rebuilt from the merged lse is its share of the whole softmax, so
    the two dQ sum to the whole dQ, and each part's dK/dV lands at its
    keys' rows of a zero (B, S, Hkv, D) buffer. A CPU tensor takes the
    kernels' plain versions; a CUDA tensor launches the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, index):
        parts = _key_parts(k, v, index, q.shape[1])
        out, lse = _merge_parts([_fa.flash_attention_fwd(
            q, kk, vv, causal=causal)
            for kk, vv, causal, _ in parts], q.dtype)
        ctx.save_for_backward(q, out, lse, *[t for kk, vv, _, _ in parts
                                             for t in (kk, vv)])
        ctx.parts = [(causal, start) for _, _, causal, start in parts]
        ctx.kv_shape = k.shape
        return out

    @staticmethod
    def backward(ctx, do):
        q, out, lse, *kv = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = _fa.attention_delta(out, do)
        cuda = q.device.type == "cuda"
        bwd_dq = _fa.flash_bwd_dq if cuda else _fa.flash_bwd_dq_plain
        bwd_dkv = _fa.flash_bwd_dkv if cuda else _fa.flash_bwd_dkv_plain
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = kv[0].new_zeros(ctx.kv_shape)
        dv = kv[1].new_zeros(ctx.kv_shape)
        for i, (causal, start) in enumerate(ctx.parts):
            kk, vv = kv[2 * i], kv[2 * i + 1]
            dq += bwd_dq(q, kk, vv, do, lse, delta, causal=causal).float()
            dk_p, dv_p = bwd_dkv(q, kk, vv, do, lse, delta, causal=causal)
            dk[:, start:start + kk.shape[1]] = dk_p
            dv[:, start:start + vv.shape[1]] = dv_p
        return dq.to(q.dtype), dk, dv, None


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, index: int, *,
                                impl: str = "auto") -> torch.Tensor:
    """q: (B, c, Hq, D), chunk `index` of a sequence cut into chunks of
    c; k/v: (B, S, Hkv, D), the whole sequence (`all_gather_seq`).
    Returns (B, c, Hq, D): the rows of the whole sequence's causal
    attention for this chunk. The route is `multi_head_attention`'s for
    the chunk's diagonal block (Sq == Sk); see the module docstring."""
    c = q.shape[1]
    impl = resolve_impl(impl, q, k[:, :c], v[:, :c], True, None)
    if impl == "dpa":
        raise ValueError("impl='dpa' under sequence parallelism: SDPA "
                         "returns no logsumexp to merge a chunk's parts "
                         "by; use impl='pallas' or 'xla'")
    if impl == "xla":
        end = (index + 1) * c
        return einsum_attention(q, k[:, :end], v[:, :end], causal=True)
    return _SplitPrefixAttention.apply(q.contiguous(), k, v, index)


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, causal: bool = True,
                     segment_ids: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """The plain path of `multi_head_attention` on any device: fp32
    scores, offset causal mask, GQA repeat, segment masks."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device),
                          diagonal=sk - sq)[None, None]
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full_like(logits, _F32_MIN))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend_cached(q, ck, cv, positions, new_lengths, scale):
    """Shared tail of the contiguous and paged cached paths: length mask
    + causal mask + GQA repeat + softmax(QK)V, scores in fp32."""
    L = ck.shape[1]
    rep = q.shape[2] // ck.shape[2]
    ar = torch.arange(L, device=q.device)
    valid = ar[None, :] < new_lengths[:, None]
    logits_mask = torch.where(valid, 0.0, _F32_MIN)
    kk = _repeat_kv(ck, rep)
    vv = _repeat_kv(cv, rep)
    att = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    att = att + logits_mask[:, None, None, :]
    pos_k = ar[None, None, None, :]
    pos_q = positions[:, None, :, None]
    att = torch.where(pos_k <= pos_q, att, torch.full_like(att, _F32_MIN))
    probs = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv.to(q.dtype))


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache, positions: torch.Tensor,
                     scale: Optional[float] = None, impl: str = "auto"):
    """Attention of new tokens against a per-sequence KV cache.

    q/k/v: (B, S, H{q,kv}, D) for the new tokens; cache = (ck, cv,
    lengths) with ck/cv (B, L, Hkv, D), or a PagedKV. Writes k/v at
    `positions` (B, S) in place, attends causally over the written
    prefix, and returns (out (B, S, Hq, D), new_cache). `impl` (the
    model's attn_impl) routes the paged cache's fresh prefill."""
    if isinstance(cache, PagedKV):
        return paged_cached_attention(q, k, v, cache, positions,
                                      scale=scale, impl=impl)
    b, _, _, d = q.shape
    if scale is None:
        scale = d ** -0.5
    ck, cv, lengths = cache
    idx = torch.arange(b, device=q.device)[:, None]
    pos = positions.long()
    ck[idx, pos] = k.to(ck.dtype)
    cv[idx, pos] = v.to(cv.dtype)
    new_lengths = torch.maximum(lengths, (positions[:, -1] + 1)
                                .to(lengths.dtype))
    out = _attend_cached(q, ck, cv, positions, new_lengths, scale)
    return out, (ck, cv, new_lengths)


class PagedKV:
    """Per-layer paged KV cache entry.

    k_flat/v_flat: (N_flat, Hkv, D), the shared page pool flattened to
      token rows; N_flat = (n_pages + trash) * page_size.
    page_table: (B, P) int32 page ids backing each sequence, in order:
      logical position p of row b lives at flat row
      page_table[b, p // page_size] * page_size + p % page_size.
      Unallocated entries point at a trash page.
    lengths: (B,) int32 tokens currently valid per sequence.
    fresh=True marks a pure prefill (every sequence starts at length 0):
      attention runs over the new tokens alone (K1) while KV still
      scatters into the pages.
    """

    def __init__(self, k_flat, v_flat, page_table, lengths,
                 page_size: int, fresh: bool = False):
        self.k_flat = k_flat
        self.v_flat = v_flat
        self.page_table = page_table
        self.lengths = lengths
        self.page_size = page_size
        self.fresh = fresh

    def flat_rows(self, positions: torch.Tensor) -> torch.Tensor:
        """Flat pool row (int64) of each (sequence, logical position) in
        `positions` (B, S). A page index past the table's width clamps
        to its last column, as the JAX gather clamps."""
        ps = self.page_size
        pos = positions.long()
        col = (pos // ps).clamp(max=self.page_table.shape[1] - 1)
        return torch.gather(self.page_table.long(), 1, col) * ps + pos % ps


def paged_cached_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, cache: PagedKV,
                           positions: torch.Tensor,
                           scale: Optional[float] = None,
                           impl: str = "auto"):
    """cached_attention semantics over a PagedKV pool (written in
    place). Returns (out (B, S, Hq, D), PagedKV with the new lengths)."""
    b, s, hq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    k_flat, v_flat = cache.k_flat, cache.v_flat
    page_table, lengths = cache.page_table, cache.lengths
    ps = cache.page_size

    flat_pos = cache.flat_rows(positions).reshape(-1)
    k_flat.index_copy_(0, flat_pos,
                       k.to(k_flat.dtype).reshape(b * s, *k.shape[2:]))
    v_flat.index_copy_(0, flat_pos,
                       v.to(v_flat.dtype).reshape(b * s, *v.shape[2:]))
    new_lengths = torch.maximum(
        lengths, (positions[:, -1] + 1).to(lengths.dtype))
    new_cache = PagedKV(k_flat, v_flat, page_table, new_lengths, ps)
    paged = paged_attn_impl()

    if cache.fresh and paged != "gather":
        # pure prefill: no prior context, attend over the new tokens
        # (K1 where it takes the call). Padding-tail keys only reach
        # discarded query rows.
        out = multi_head_attention(q, k.to(q.dtype), v.to(q.dtype),
                                   causal=True, impl=impl, scale=scale)
        return out, new_cache

    if s == 1 and (paged == "pallas" or (
            paged == "auto" and q.is_cuda and paged_decode_takes(
                d, hq, k_flat.shape[1], q.dtype, k_flat.dtype,
                v_flat.dtype))):
        # one-token decode: K3 reads the pages in place, no gather
        out = paged_decode_attention(
            q[:, 0].contiguous(), k_flat, v_flat, page_table.contiguous(),
            new_lengths.to(torch.int32).contiguous(), ps,
            qpos=positions[:, 0].to(torch.int32).contiguous(),
            scale=scale)
        return out[:, None], new_cache

    # every other shape: gather each sequence's contiguous KV view
    n_pages = page_table.shape[1]
    gather_idx = (page_table.long()[:, :, None] * ps
                  + torch.arange(ps, device=q.device)[None, None, :]
                  ).reshape(b, n_pages * ps)
    ck = k_flat[gather_idx]                           # (B, L, Hkv, D)
    cv = v_flat[gather_idx]
    out = _attend_cached(q, ck, cv, positions, new_lengths, scale)
    return out, new_cache
