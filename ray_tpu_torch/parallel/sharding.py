"""Parameter and activation sharding rules (counterpart of
ray_tpu/parallel/sharding.py).

The table is the reference's, re-expressed on the port's parameter names
and its (out, in) weight layout: where the reference writes
`P("fsdp", "tp")` for a q_proj kernel (in, out), the port writes
`P("tp", "fsdp")` for q_proj.weight (out, in). Embeddings (vocab, d),
the router (d, E) and the stacked experts keep the reference's layout
and specs. `spec_for` gives the reference's answers, including
replication where an axis does not divide a dim.

`shard_module` applies the table to a module on a `DeviceMesh` from
`build_mesh`, where XLA would apply it to a pytree:
- tp: a projection whose table entry puts tp on its output dim becomes
  `ColwiseParallel`, on its input dim `RowwiseParallel`; the embedding
  is vocab-parallel (`RowwiseParallel`); a head the plans do not cover
  (Llama's `_LMHead`, the int8 `QuantDense` buffers) is distributed over
  vocab / its table dim with `distribute_tensor` and computes on local
  shards (ops/linear.py, ops/quant.py). A head is never split across
  ranks: attention projections whose head count tp does not divide stay
  replicated, and where tp divides the query heads but not the kv
  heads, k/v stay replicated and each rank selects the kv heads its
  query heads read. GPT-2's fused `qkv` (rows [q; k; v]) is sharded
  with `_StridedShard(0, split_factor=3)`: rank t holds rows [q_t; k_t;
  v_t], whole heads of each, and the parameter keeps its name, its
  (3 d, d) shape and its row order in `state_dict()`, the optimizer's
  moments and checkpoints (`full_tensor` below gives the unsharded
  weight), so nothing outside the block knows; the block computes on
  the local rows (models/gpt2.py). FSDP2 shards the weight's columns,
  which makes its shard the table's. The bias stays out of FSDP2, whole
  over fsdp as the table's P() has it: its one dim is the one tp splits
  three ways, and FSDP2 would split it again, nesting two strided
  layouts; over tp it holds its third of each of q, k and v, which the
  block's local rows need.
- ep and tp on the experts: the stacked expert weights are sharded over
  ep on dim 0 (each ep rank holds E / ep experts) and over tp on their
  ff dim ((E, d, ff) on dim 2, (E, ff, d) on dim 1), one DTensor on the
  mesh of those axes (ep alone when both are 1), and FSDP2 takes that
  DTensor with the block's other parameters and shards its d dim over
  fsdp: each rank holds the table's shard, P("ep", "fsdp", "tp") of
  gate/up and P("ep", "tp", "fsdp") of down, on an (fsdp, ep[, tp])
  mesh ((dp, fsdp, ep[, tp]) under HSDP). FSDP2 gathers them over fsdp
  in the block's pre-forward, before the grouped expert product, and
  reduce-scatters their gradients over fsdp; ep is a data axis whose
  exchange already summed them over ep, so the train step adds only sp
  (train/spmd.py `_summed_over`). ops/moe.py moves the tokens to them
  with all-to-all on the ep group of that mesh (the mesh's own ep
  group: a sub-mesh shares its parent's groups), and each tp rank
  computes its ff slice, the down product's partial sums all-reduced
  over tp (models/mixtral.py).
- fsdp: `fully_shard` per block, then the root, on the dim the table
  gives fsdp (FSDP2 shards every parameter it manages; one the table
  replicates is sharded on dim 0). dp is FSDP2's replicate dim (HSDP
  over ("dp", "fsdp")). Master weights and the all-gather stay fp32.
- sp does not shard a module: parameters are replicated over it. The
  train step publishes the mesh while its forward and backward run
  (`activation_mesh`), and a model that finds an sp axis there
  (`sequence_shard`) takes its input as this rank's sequence chunk:
  RoPE and learned positions at the chunk's global positions, K/V
  gathered over sp (`collectives.all_gather_seq`), attention through
  `ops.attention.sequence_parallel_attention`, the MoE queue in the
  global token order.
pp does not shard a module either, and `shard_module` refuses it: the
pipelines (parallel/pipeline*.py) take that axis.

Conventions for decoder transformers (ray_tpu_torch/models/*), the
port's layout:
  embed      (vocab, d)        -> P(("tp", "fsdp"), None)  vocab-parallel
  attn qkv   (heads*hd, d)     -> P("tp", "fsdp")     column parallel
  attn out   (d, heads*hd)     -> P("fsdp", "tp")     row parallel
  mlp gate/up(ff, d)           -> P("tp", "fsdp")     column parallel
  mlp down   (d, ff)           -> P("fsdp", "tp")     row parallel
  norms      (d,)              -> P()                  replicated
Activations: batch rows over the data axes (dp, fsdp, ep), sequence
over sp.
"""
from __future__ import annotations

import dataclasses
import re
from typing import (Any, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch
from torch import nn

from .collectives import axis_size, data_axes, data_rank, data_size
from .mesh import AXIS_ORDER, MeshSpec


class P(tuple):
    """PartitionSpec: one entry per tensor dim, each None (replicated),
    an axis name, or a tuple of axis names (sharded over their
    product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


Rule = Tuple[str, P]

_W = r"(weight|kernel_q)$"     # a projection's weight, fp or int8

DEFAULT_RULES: Sequence[Rule] = (
    # MoE experts first: their paths can also contain generic names like
    # gate_proj, and first-match must pick the 3-axis ep spec. The
    # stacked experts keep flax's (E, in, out) layout.
    (r".*experts.*(gate|up).*kernel$", P("ep", "fsdp", "tp")),
    (r".*experts.*down.*kernel$", P("ep", "tp", "fsdp")),
    (r".*router.*kernel$", P("fsdp", None)),
    # vocab-parallel embedding, d_model unsharded (see the reference)
    (r".*(token_embed|embed_tokens|wte)\b.*weight$",
     P(("tp", "fsdp"), None)),
    # untied output head (vocab, d): column-parallel over vocab
    (r".*(lm_head|output_proj)\b.*weight$", P("tp", "fsdp")),
    (r".*(wq|wk|wv|qkv|q_proj|k_proj|v_proj)\b.*" + _W,
     P("tp", "fsdp")),
    (r".*(wo|o_proj|out_proj|attn_out)\b.*" + _W, P("fsdp", "tp")),
    (r".*(gate_proj|up_proj|w1|w3|fc_in)\b.*" + _W,
     P("tp", "fsdp")),
    (r".*(down_proj|w2|fc_out)\b.*" + _W, P("fsdp", "tp")),
    (r".*(pos_embed|wpe)\b.*weight$", P(None, "fsdp")),
    (r".*(norm|ln_f|ln_1|ln_2|layernorm).*$", P()),
    (r".*bias$", P()),
    (r".*scale$", P()),
)

MeshLike = Union["DeviceMesh", MeshSpec, Mapping[str, int]]  # noqa: F821


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, a MeshSpec or such a dict."""
    if isinstance(mesh, MeshSpec):
        return mesh.axis_sizes()
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in AXIS_ORDER}
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


@dataclasses.dataclass
class ShardingRules:
    rules: Sequence[Rule] = DEFAULT_RULES
    default: P = dataclasses.field(default_factory=P)

    def spec_for(self, path: str, shape: Tuple[int, ...],
                 mesh: MeshLike) -> P:
        return _clip_to_mesh(self._match(path), shape, axis_sizes(mesh))

    def _match(self, path: str) -> P:
        for pattern, spec in self.rules:
            if re.match(pattern, path):
                return spec
        return self.default


def _clip_to_mesh(spec: P, shape: Tuple[int, ...],
                  sizes: Mapping[str, int]) -> P:
    """Drop axes not in the mesh / of size 1, and any axis that doesn't
    divide the dimension, falling back to replication for that dim."""
    out = []
    for i, entry in enumerate(spec):
        if i >= len(shape):
            break
        dim = shape[i]
        names = entry if isinstance(entry, tuple) else (
            (entry,) if entry is not None else ())
        kept = []
        prod = 1
        for name in names:
            sz = sizes.get(name, 1)
            if sz > 1 and dim % (prod * sz) == 0:
                kept.append(name)
                prod *= sz
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def partition_spec_for(path: str, shape: Tuple[int, ...], mesh: MeshLike,
                       rules: Optional[ShardingRules] = None) -> P:
    return (rules or ShardingRules()).spec_for(path, shape, mesh)


def path_str(path) -> str:
    """Canonical name of a parameter path: a dotted module path as
    given, or a sequence of keys joined by "." (the port's names are
    `named_parameters()` names; the reference joins with "/")."""
    if isinstance(path, str):
        return path
    return ".".join(str(getattr(p, "key", p)) for p in path)


def dim_of(spec: P, axis: str) -> Optional[int]:
    """The dim of `spec` sharded over `axis`, or None."""
    for i, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i
    return None


def _placements(spec: P, mesh) -> list:
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(d) if d is not None else Replicate()
            for d in (dim_of(spec, a) for a in mesh.mesh_dim_names)]


def sharding_tree(params: Mapping[str, torch.Tensor], mesh,
                  rules: Optional[ShardingRules] = None) -> Dict[str, list]:
    """{name: placements} for a flat dict of tensors on a `DeviceMesh`
    (the counterpart of the reference's tree of NamedShardings): the
    table's spec of each tensor as one placement per mesh dim, Shard(d)
    where the spec puts that axis on dim d, else Replicate. Where a spec
    puts several axes on one dim, DTensor orders their pieces by mesh
    dim (the reference by the spec's tuple): the same whole tensor."""
    rules = rules or ShardingRules()
    return {n: _placements(rules.spec_for(n, tuple(t.shape), mesh), mesh)
            for n, t in params.items()}


def shard_pytree(params: Mapping[str, torch.Tensor], mesh,
                 rules: Optional[ShardingRules] = None
                 ) -> Dict[str, torch.Tensor]:
    """Every tensor of a flat dict distributed onto the mesh by the
    table (`distribute_tensor` with `sharding_tree`'s placements; rank
    0's values are the ones kept)."""
    from torch.distributed.tensor import distribute_tensor
    return {n: distribute_tensor(params[n], mesh, pl)
            for n, pl in sharding_tree(params, mesh, rules).items()}


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective over its mesh), or t.
    DTensor's own `full_tensor` redistributes a layout with a
    `_StridedShard` (GPT-2's qkv under tp) on some torch versions only,
    so such a tensor is assembled here, mesh dim by mesh dim from the
    last: every rank's part gathered over that dim and each of the
    placement's split_factor pieces put back together (every shard even,
    as a whole number of heads is)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    if not any(hasattr(p, "split_factor") for p in t.placements):
        return t.full_tensor()
    import torch.distributed as dist
    mesh, out = t.device_mesh, t.to_local()
    for i in reversed(range(mesh.ndim)):
        p, n = t.placements[i], mesh.size(i)
        if p.is_replicate() or n == 1:
            continue
        parts = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(parts, out.contiguous(), group=mesh.get_group(i))
        f = getattr(p, "split_factor", 1)
        out = torch.cat([torch.cat([x.chunk(f, p.dim)[j] for x in parts],
                                   p.dim) for j in range(f)], p.dim)
    return out


def replicated(mesh) -> list:
    """Placements of a tensor whole on every rank of `mesh`."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


# ---- applying the table ----------------------------------------------------

def _is_attention(m: nn.Module) -> bool:
    return all(hasattr(m, a) for a in ("q_proj", "k_proj", "v_proj",
                                       "o_proj")) and hasattr(m, "cfg")


def _attention_plan(prefix: str, attn: nn.Module, tp_mesh
                    ) -> Dict[str, bool]:
    """Which of an attention's projections tp may shard (whole heads
    only), and, when q is sharded and k/v are not, the kv heads this
    rank's query heads read (`kv_index`) and the tp group that sums the
    ranks' parts of the k/v gradients (`kv_group`)."""
    tp, tp_rank = tp_mesh.size(), tp_mesh.get_local_rank()
    hq, hkv = attn.cfg.n_heads, attn.cfg.n_kv_heads
    q_ok = hq % tp == 0
    kv_ok = q_ok and hkv % tp == 0
    attn.kv_index, attn.kv_group = None, None
    if q_ok and not kv_ok:
        attn.kv_group = tp_mesh.get_group()
        rep, local = hq // hkv, hq // tp
        dev = next(iter(attn.state_dict().values())).device
        attn.kv_index = torch.tensor(
            [(tp_rank * local + j) // rep for j in range(local)],
            dtype=torch.long, device=dev)
    return {f"{prefix}.q_proj": q_ok, f"{prefix}.o_proj": q_ok,
            f"{prefix}.k_proj": kv_ok, f"{prefix}.v_proj": kv_ok}


def _is_fused_attention(m: nn.Module) -> bool:
    """GPT-2's block: one `qkv` projection (rows [q; k; v]) and
    `attn_out`."""
    return (hasattr(m, "qkv") and hasattr(m, "attn_out")
            and hasattr(getattr(m, "cfg", None), "n_heads"))


def _strided_rows(w: torch.Tensor, tp_mesh) -> nn.Parameter:
    """w (3 n, ...) as a DTensor over tp with _StridedShard(0, 3): rank
    t's local rows are the t-th chunk of each third, concatenated."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    t, n = tp_mesh.get_local_rank(), tp_mesh.size()
    local = torch.cat([third.chunk(n, 0)[t] for third in w.chunk(3, 0)])
    return nn.Parameter(DTensor.from_local(
        local.contiguous(), tp_mesh, [_StridedShard(0, split_factor=3)],
        run_check=False, shape=w.shape, stride=w.stride()))


def _apply_tp(model: nn.Module, mesh, rules: ShardingRules) -> set:
    """The tp plans; returns the tp-strided qkv parameters (FSDP2 must
    not shard their rows again: shard_module gives it a weight's
    columns and leaves a bias out)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)
    from ..ops.quant import QuantDense
    tp_mesh = mesh["tp"]
    strided = set()
    allowed: Dict[str, bool] = {}
    for name, m in model.named_modules():
        if _is_attention(m):
            allowed.update(_attention_plan(name, m, tp_mesh))
        elif _is_fused_attention(m):
            # whole heads only, as for the separate projections
            ok = m.cfg.n_heads % tp_mesh.size() == 0
            allowed.update({f"{name}.qkv": ok, f"{name}.attn_out": ok})
    plan = {}
    for name, m in model.named_modules():
        if allowed.get(name) is False:
            continue
        if isinstance(m, QuantDense):
            spec = rules.spec_for(f"{name}.kernel_q",
                                  tuple(m.kernel_q.shape), mesh)
            dim = dim_of(spec, "tp")
            if dim is not None:
                m.kernel_q = distribute_tensor(m.kernel_q, tp_mesh,
                                               [Shard(dim)])
            continue
        w = getattr(m, "weight", None)
        if not isinstance(w, nn.Parameter) or w.ndim != 2:
            continue
        dim = dim_of(rules.spec_for(f"{name}.weight", tuple(w.shape), mesh),
                     "tp")
        if dim is None:
            continue
        if name.rpartition(".")[2] == "qkv" and dim == 0:
            # rows [q; k; v]: each rank whole heads of each (models/gpt2.py
            # computes on the local rows)
            m.weight = _strided_rows(w.data, tp_mesh)
            strided.add(m.weight)
            if m.bias is not None:
                m.bias = _strided_rows(m.bias.data, tp_mesh)
                strided.add(m.bias)
            continue
        if isinstance(m, nn.Embedding):
            # vocab-parallel lookup of the whole (replicated) token ids
            plan[name] = RowwiseParallel(input_layouts=Replicate())
        elif isinstance(m, nn.Linear):
            head = re.search(r"(lm_head|output_proj)$", name) is not None
            plan[name] = (RowwiseParallel() if dim == 1 else
                          ColwiseParallel(output_layouts=Replicate())
                          if head else ColwiseParallel())
        elif dim == 0:
            # a head the plans do not cover: vocab-sharded weight, local
            # logits gathered in ops/linear.py logits_fp32
            m.weight = nn.Parameter(distribute_tensor(w.data, tp_mesh,
                                                      [Shard(0)]))
        else:
            raise NotImplementedError(f"{name}: no tp plan for "
                                      f"{type(m).__name__} on dim {dim}")
    if plan:
        parallelize_module(model, tp_mesh, plan)
    return strided


def _apply_experts(model: nn.Module, mesh, rules: ShardingRules) -> set:
    """The stacked experts (the table's ep entries) as DTensors over ep
    on dim 0 and tp on their ff dim, on the mesh of those two axes that
    are larger than one (ep alone when neither is: the degenerate mesh
    still takes this path). An axis the table gives a dim that it does
    not divide replicates; on an axis of size one the table's dim is
    kept (a shard of one is the whole). Returns them: shard_module hands
    them to FSDP2 with the other parameters, which adds fsdp on their d
    dim (the table's, at fsdp 1 too): the parameter FSDP2 holds is a
    DTensor on (fsdp, ep[, tp]), and with dp > 1 on (dp, fsdp, ep[,
    tp])."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in ("ep", "tp") if sizes[a] > 1) or ("ep",)
    sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]
    experts = set()
    for mod_name, m in model.named_modules():
        for pname, p in list(m.named_parameters(recurse=False)):
            full = f"{mod_name}.{pname}" if mod_name else pname
            table = rules._match(full)
            if dim_of(table, "ep") is None:
                continue
            spec = rules.spec_for(full, tuple(p.shape), mesh)
            dims = [dim_of(spec if sizes[a] > 1 else table, a) for a in axes]
            q = nn.Parameter(distribute_tensor(
                p.data, sub, [Replicate() if d is None else Shard(d)
                              for d in dims]))
            setattr(m, pname, q)
            experts.add(q)
    return experts


def data_mesh(mesh):
    """The mesh FSDP2 shards over: ("dp", "fsdp") as HSDP when dp > 1,
    else "fsdp"."""
    return mesh["dp", "fsdp"] if axis_size(mesh, "dp") > 1 else mesh["fsdp"]


def shard_module(model: nn.Module, mesh,
                 rules: Optional[ShardingRules] = None) -> nn.Module:
    """Apply the table to `model` in place on `mesh` (see the module
    docstring) and return it. Every rank must hold the same full weights
    before the call; each keeps its shards after it. Models whose MoE
    layers route (`moe_mesh`) learn the mesh here. A model sharded
    already is returned as it is. sp replicates the parameters (the
    train step cuts the sequence); pp raises."""
    from torch.distributed.fsdp import FSDPModule, fully_shard
    from torch.distributed.tensor import Shard
    if isinstance(model, FSDPModule):
        return model
    rules = rules or ShardingRules()
    sizes = axis_sizes(mesh)
    if sizes["pp"] > 1:
        raise NotImplementedError(
            f"shard_module: pp={sizes['pp']} does not shard a module; it "
            f"is taken by parallel.pipeline_train.PipelinedLM")
    strided = _apply_tp(model, mesh, rules) if sizes["tp"] > 1 else set()
    ignored = {p for p in strided if p.ndim == 1}
    experts = _apply_experts(model, mesh, rules)
    for m in model.modules():
        if hasattr(m, "moe_mesh"):
            m.moe_mesh = mesh
    names = {p: n for n, p in model.named_parameters()}

    def placement(p):
        if p in strided:      # tp holds the rows: fsdp takes the columns
            return Shard(1)
        spec = rules.spec_for(names[p], tuple(p.shape), mesh)
        if p in experts and sizes["fsdp"] == 1:
            spec = rules._match(names[p])     # their d dim, as on ep and tp
        dim = dim_of(spec, "fsdp")
        return Shard(dim if dim is not None else 0)

    dmesh = data_mesh(mesh)
    for block in getattr(model, "blocks", ()):
        own = ignored & set(block.parameters())
        fully_shard(block, mesh=dmesh, shard_placement_fn=placement,
                    **({"ignored_params": own} if own else {}))
    fully_shard(model, mesh=dmesh, shard_placement_fn=placement,
                **({"ignored_params": ignored} if ignored else {}))
    return model


# ---- the batch ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """This rank's share of a global batch: rows `row_index` of
    `n_rows` equal parts, and under sp the sequence chunk `seq_index`
    of `n_seq` (the counterpart of a NamedSharding over (data, sp))."""
    row_index: int = 0
    n_rows: int = 1
    seq_index: int = 0
    n_seq: int = 1

    def shift_tokens(self, batch: Mapping) -> dict:
        """Under sp, a batch of `tokens` (B, S + 1) as the `inputs`
        (tokens[:, :-1]) and `targets` (tokens[:, 1:]) the loss would
        take, so that the cut over sp keeps each chunk's last target (the
        next chunk's first token); S must divide by sp. Any other batch,
        and any batch without sp, as it is."""
        if self.n_seq == 1 or "tokens" not in batch or "inputs" in batch:
            return dict(batch)
        out = {k: v for k, v in batch.items() if k != "tokens"}
        tokens = batch["tokens"]
        s = tokens.shape[1] - 1
        if s % self.n_seq:
            raise ValueError(
                f"a tokens batch of {s + 1} columns gives inputs and "
                f"targets of {s}, which do not split over sp={self.n_seq}")
        out["inputs"], out["targets"] = tokens[:, :-1], tokens[:, 1:]
        return out

    def shard(self, x):
        """The local part of a tensor or array (B, S, ...), or of every
        value of a dict (after `shift_tokens`), as a `LocalBatch`; a
        `LocalBatch` of this sharding is returned as it is (it holds the
        local part already)."""
        if isinstance(x, LocalBatch):
            if x.sharding != self:
                raise ValueError(f"a batch local to {x.sharding} given to "
                                 f"a step that shards by {self}")
            return x
        if isinstance(x, Mapping):
            return LocalBatch({k: self.shard(v) for k, v in
                               self.shift_tokens(x).items()}, self)
        b = x.shape[0]
        if b % self.n_rows:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"{self.n_rows} data ranks")
        m = b // self.n_rows
        x = x[self.row_index * m:(self.row_index + 1) * m]
        if self.n_seq > 1:
            s = x.shape[1]
            if s % self.n_seq:
                raise ValueError(f"sequence of {s} does not split over "
                                 f"sp={self.n_seq}")
            c = s // self.n_seq
            x = x[:, self.seq_index * c:(self.seq_index + 1) * c]
        return x


class LocalBatch(dict):
    """A batch that holds this rank's share of a global batch already
    (`sharding.shard`'s part of it): what `data.device_put_iterator`
    yields with a `sharding`, having copied only those rows. A mesh
    train step takes it as it is, and a plain dict as the global batch."""

    def __init__(self, data, sharding: BatchSharding):
        super().__init__(data)
        self.sharding = sharding


def batch_sharding(mesh, *, seq_axis: Optional[str] = "sp"
                   ) -> BatchSharding:
    """Input batch (B, S, ...): rows over the data axes (dp, fsdp, ep),
    sequence over sp."""
    n_seq = axis_size(mesh, seq_axis) if seq_axis else 1
    return BatchSharding(data_rank(mesh), data_size(mesh),
                         mesh.get_local_rank(seq_axis) if n_seq > 1 else 0,
                         n_seq)


# ---- activation constraints ------------------------------------------------
# The reference's train step publishes its mesh while tracing so models
# can pin (B, S, D) activations to batch over the data axes and sequence
# over sp, keeping XLA's propagation from resharding the residual
# stream. Eager PyTorch has no propagation to steer: each rank's
# activations are local tensors of its own rows, and the tp plans
# decide the layout of every projection's output, so
# `constrain_activations` returns x unchanged. The port's step publishes
# its mesh too, around the forward and the backward (a remat block
# recomputes there): under sp the models read it (`sequence_shard`) to
# treat their input as this rank's sequence chunk.
_ACTIVATION_MESH: list = [None]


class SeqShard(NamedTuple):
    """This rank's sequence chunk under a published sp mesh."""
    group: Any       # the sp process group
    index: int       # this rank's chunk
    count: int       # chunks (the sp size)


def published_mesh():
    """The mesh published by `activation_mesh` (a train step's, or a
    LearnerGroup's while its loss runs), else None."""
    return _ACTIVATION_MESH[0]


def sequence_shard() -> Optional[SeqShard]:
    """The published mesh's sp group, chunk index and count, or None
    when no mesh is published or its sp is 1."""
    mesh = published_mesh()
    if mesh is None or axis_size(mesh, "sp") == 1:
        return None
    return SeqShard(mesh.get_group("sp"), mesh.get_local_rank("sp"),
                    axis_size(mesh, "sp"))


class activation_mesh:
    """Context manager: publish `mesh` to constrain_activations,
    sequence_shard and published_mesh."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._prev = _ACTIVATION_MESH[0]
        _ACTIVATION_MESH[0] = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVATION_MESH[0] = self._prev
        return False


def constrain_activations(x, *, seq_axis: Optional[str] = "sp"):
    """x unchanged: a rank's activations already are its rows (and, under
    sp, its sequence chunk); see the comment above."""
    return x


__all__ = ["P", "Rule", "DEFAULT_RULES", "ShardingRules", "axis_sizes",
           "partition_spec_for", "path_str", "dim_of",
           "sharding_tree", "shard_pytree", "full_tensor", "replicated",
           "shard_module", "data_mesh", "data_axes", "BatchSharding",
           "batch_sharding", "LocalBatch", "activation_mesh", "constrain_activations",
           "SeqShard", "sequence_shard", "published_mesh"]
