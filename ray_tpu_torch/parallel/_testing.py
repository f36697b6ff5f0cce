"""Rank functions for the parallel paths' parity checks.

`train.backend.launch` pickles a function by reference into fresh
interpreters, so the bodies the ranks run live here, in the port,
where importing them loads neither JAX nor the JAX package. Each takes
plain data (numpy weights and batches, made by the caller from a seed)
and returns numpy results from rank 0 (None from the others), whole
tensors gathered over the mesh. They run on the CPU (gloo) unless a
case names another device.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _whole(t):
    from .sharding import full_tensor
    return full_tensor(t)


def _np(t) -> np.ndarray:
    return _whole(t).detach().float().cpu().numpy()


def _rank0(x):
    return x if dist.get_rank() == 0 else None


def _batch(b: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in b.items()}


_MESHES: Dict[tuple, Any] = {}


def _mesh(spec: Dict[str, int], device: str = "cpu"):
    """build_mesh(MeshSpec(**spec)), one a spec in this rank (each build
    makes a process group per axis)."""
    from ..parallel.mesh import MeshSpec, build_mesh
    key = (tuple(sorted(spec.items())), device)
    if key not in _MESHES:
        _MESHES[key] = build_mesh(MeshSpec(**spec), device=device)
    return _MESHES[key]


def _model(case, dev):
    """The case's model (llama, mixtral or gpt2) in fp32 from its
    params; case["port_cfg"] overrides config fields on this side only
    (an attention route)."""
    from ..models import (GPT2, GPT2Config, Llama, LlamaConfig, Mixtral,
                          MixtralConfig)
    kinds = {"llama": (Llama, LlamaConfig), "mixtral": (Mixtral,
                                                        MixtralConfig),
             "gpt2": (GPT2, GPT2Config)}
    cls, cfg_cls = kinds[case.get("model", "llama")]
    cfg = cfg_cls(**{**case["cfg"], **case.get("port_cfg", {})},
                  dtype=torch.float32, param_dtype=torch.float32)
    model = cls(cfg, device=dev)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in case["params"].items()})
    return model


def _expert_shapes_at_forward(model) -> Dict[str, list]:
    """Forward pre-hooks on the MoE layers that record, the first time
    each runs, the local shape of each stacked expert weight as the
    grouped expert product will read it (after FSDP2's all-gather)."""
    seen: Dict[str, list] = {}
    for name, m in model.named_modules():
        if not hasattr(m, "moe_mesh"):
            continue

        def hook(mod, args, name=name):
            for p, w in mod.named_parameters(recurse=False):
                if p.startswith("experts_") and f"{name}.{p}" not in seen:
                    local = w.to_local() if isinstance(w, DTensor) else w
                    seen[f"{name}.{p}"] = list(local.shape)

        m.register_forward_pre_hook(hook)
    return seen


def train_cases(cases: List[Dict[str, Any]]):
    """For each case: `make_train_step` on MeshSpec(**case["spec"]) for
    its batches; per step loss, grad_norm and ntokens, then the whole
    params and, of rank 0's shard of each, the element count, the local
    shape, the DTensor's mesh dims and placements. For a MoE model,
    each stacked expert weight's local shape when its layer's forward
    starts (`at_forward`), and whether the ep exchange's group
    (`moe_mesh`'s ep) holds the ranks of the ep dim of the experts'
    own mesh."""
    from ..train import make_optimizer, make_train_step
    out = []
    for case in cases:
        dev = torch.device(case.get("device", "cpu"))
        mesh = _mesh(case["spec"], dev.type)
        model = _model(case, dev)
        tx = make_optimizer(case["opt"], learning_rate=case["lr"])
        batches = [_batch(b, dev) for b in case["batches"]]
        state, step = make_train_step(
            model, tx, mesh, accum_steps=case.get("accum", 1))(batches[0])
        at_forward = _expert_shapes_at_forward(model)
        rows = []
        for b in batches:
            state, m = step(state, b)
            rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                  "ntokens")})
        sd = model.state_dict()
        params = {k: _np(v) for k, v in sd.items()}

        def local(v):
            return v.to_local() if isinstance(v, DTensor) else v

        dtensors = {k: v for k, v in sd.items() if isinstance(v, DTensor)}
        ep_ranks = {k: dist.get_process_group_ranks(
            v.device_mesh.get_group("ep")) for k, v in dtensors.items()
            if "ep" in v.device_mesh.mesh_dim_names}
        out.append(_rank0({
            "metrics": rows, "params": params,
            "local_numel": {k: local(v).numel() for k, v in sd.items()},
            "local_shape": {k: list(local(v).shape) for k, v in sd.items()},
            "mesh_dims": {k: list(v.device_mesh.mesh_dim_names)
                          for k, v in dtensors.items()},
            "placements": {k: repr(tuple(v.placements))
                           for k, v in dtensors.items()},
            "at_forward": at_forward,
            "ep_group_is_experts": all(
                r == dist.get_process_group_ranks(mesh.get_group("ep"))
                for r in ep_ranks.values()) if ep_ranks else None}))
    return out


def lora_case(case: Dict[str, Any]):
    """make_lora_train_step over the model sharded on the case's mesh:
    per step loss and grad_norm, the adapters after, and whether the
    base moved."""
    from ..train import make_lora_train_step, make_optimizer
    from ..train.lora import unflatten_adapters
    dev = torch.device("cpu")
    mesh = _mesh(case["spec"])
    model = _model(case, dev)
    lora = {"rank": case["rank"], "alpha": case["alpha"], "adapters": {
        name: {k: torch.from_numpy(np.asarray(v)) for k, v in pair.items()}
        for name, pair in case["adapters"].items()}}
    batches = [_batch(b, dev) for b in case["batches"]]
    state, step = make_lora_train_step(
        model, make_optimizer(case.get("opt", "sgd"),
                              learning_rate=case["lr"]),
        mesh=mesh)(batches[0], lora)
    base = {k: _np(v) for k, v in model.state_dict().items()}
    rows = []
    for b in batches:
        state, m = step(state, b)
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    after = {k: _np(v) for k, v in model.state_dict().items()}
    adapters = {name: {k: v.detach().numpy() for k, v in pair.items()}
                for name, pair in unflatten_adapters(state.params).items()}
    moved = [k for k in base if not np.array_equal(base[k], after[k])]
    return _rank0({"metrics": rows, "adapters": adapters,
                   "base_moved": moved})


def int8_forward(case: Dict[str, Any]):
    """An int8 Llama (case["params"]: the quantized state_dict) sharded
    on the case's mesh: logits of the global batch, gathered."""
    from ..models import Llama, LlamaConfig
    from ..parallel.collectives import all_gather_axes, data_axes
    from ..parallel.sharding import batch_sharding, shard_module
    mesh = _mesh(case["spec"])
    cfg = LlamaConfig(**case["cfg"], dtype=torch.float32,
                      param_dtype=torch.float32, quant="int8")
    model = Llama(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in case["params"].items()})
    shard_module(model, mesh)
    tokens = batch_sharding(mesh).shard(torch.from_numpy(case["tokens"]))
    with torch.no_grad():
        logits, _ = model(tokens)
    every = all_gather_axes(logits.contiguous(), mesh, data_axes(mesh))
    kq = model.layer_0.attention.q_proj.kernel_q
    return _rank0({"logits": every.reshape(-1, *logits.shape[1:]).numpy(),
                   "q_placements": repr(getattr(kq, "placements", None))})


def checkpoint_case(case: Dict[str, Any]):
    """Save a Llama sharded at case["save"] (a MeshSpec dict), restore
    it onto a model prepared on each of case["restore"] (MeshSpec
    dicts; shard by shard from the host file) and onto one device; the
    whole tensors of every restore against the saved model's, bit for
    bit. For each mesh restore, what this rank moved: the bytes of
    every tensor that went through `Tensor.to` against the bytes of its
    shards (each DTensor's local tensor of the layout, as `redistribute`
    lays it out) and plain leaves, every rank's shards of the layout's
    local shapes and each in a storage of its own bytes (nothing of the
    whole tensor kept). Then a saved tensor of another shape than its
    layout: whether the restore raises."""
    from ..parallel.sharding import shard_module
    from ..train import prepare_module, restore_pytree, save_pytree
    path = case["path"]
    saved = shard_module(_model(case, "cpu"), _mesh(case["save"]))
    save_pytree(saved.state_dict(), path, step=7)
    want = {k: _whole(v).detach() for k, v in saved.state_dict().items()}
    committed = os.path.exists(os.path.join(path, "ckpt_meta.json"))
    resharded, placements, moved, own = {}, {}, {}, {}

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def nbytes(t):
        return t.numel() * t.element_size()

    for spec in case["restore"]:
        other = prepare_module(_model({**case, "params": {
            k: np.zeros_like(v) for k, v in case["params"].items()}}, "cpu"),
            _mesh(spec))
        layout = other.state_dict()
        sizes, real_to = [], torch.Tensor.to

        def spy(t, *args, **kw):
            sizes.append(nbytes(t))
            return real_to(t, *args, **kw)

        torch.Tensor.to = spy
        try:
            tree = restore_pytree(path, shardings=layout, map_location="cpu")
        finally:
            torch.Tensor.to = real_to
        other.load_state_dict(tree)
        name = repr(sorted(spec.items()))
        got = {k: _whole(v).detach() for k, v in other.state_dict().items()}
        resharded[name] = all(torch.equal(got[k], want[k]) for k in want)
        placements[name] = sorted({repr(v.placements) for v in
                                   other.state_dict().values()
                                   if isinstance(v, DTensor)})
        moved[name] = {"moved": sum(sizes), "largest_moved": max(sizes),
                       "held": sum(nbytes(local(v)) for v in layout.values()),
                       "largest_held": max(nbytes(local(v))
                                           for v in layout.values())}
        own[name] = all(
            local(t).shape == local(layout[k]).shape
            and local(t).untyped_storage().nbytes() == nbytes(local(t))
            for k, t in tree.items())
    single = restore_pytree(path, map_location="cpu")
    key = next(k for k, v in layout.items() if isinstance(v, DTensor))
    save_pytree({key: torch.zeros(3)}, path + "_other_shape")
    try:
        restore_pytree(path + "_other_shape", shardings=layout,
                       map_location="cpu")
        mismatch_raises = False
    except ValueError:
        mismatch_raises = True
    return _rank0({
        "committed_on_return": committed,
        "resharded_equal": resharded,
        "single_equal": all(torch.equal(single[k], want[k]) for k in want),
        "n_tensors": len(want),
        "placements": placements,
        "moved": moved, "own_storage": own,
        "mismatch_raises": mismatch_raises})


def shard_pytree_case(case: Dict[str, Any]):
    """shard_pytree of the case's flat dict of weights on
    MeshSpec(**case["spec"]): each tensor's placements, whether its
    whole tensor is the input, and `replicated(mesh)`."""
    from ..parallel.sharding import replicated, shard_pytree
    mesh = _mesh(case["spec"])
    params = {k: torch.from_numpy(np.asarray(v))
              for k, v in case["params"].items()}
    out = shard_pytree(params, mesh)
    return _rank0({
        "placements": {k: [repr(p) for p in v.placements]
                       for k, v in out.items()},
        "whole_equal": all(torch.equal(_whole(out[k]), params[k])
                           for k in params),
        "replicated": [repr(p) for p in replicated(mesh)]})


def _loss_with_aux(model, batch):
    """next_token_loss plus the model's summed router losses."""
    from ..train import next_token_loss
    loss, metrics = next_token_loss(model, batch)
    return loss + model.aux_loss(), metrics


def moe_aux_case(case: Dict[str, Any]):
    """Mixtral sharded on MeshSpec(**case["spec"]): each layer's router
    loss from a forward of this rank's rows of case["tokens"] (the same
    on every rank, checked), then one mesh train step of the loss plus
    the aux loss: the router kernels' gradients as the optimizer sees
    them (the global batch's, unclipped), whole."""
    from ..parallel.collectives import all_gather_axes, data_axes
    from ..parallel.sharding import batch_sharding
    from ..train import make_optimizer, make_train_step
    mesh = _mesh(case["spec"])
    model = _model(case, "cpu")
    batch = {"tokens": torch.from_numpy(case["tokens"])}
    state, step = make_train_step(model, make_optimizer(
        "sgd", learning_rate=case["lr"], grad_clip=None), mesh,
        loss_fn=_loss_with_aux)(batch)
    local = batch_sharding(mesh).shard(batch)["tokens"]
    with torch.no_grad():
        model(local[:, :-1])
    aux = torch.stack([b.moe.router_loss for b in model.blocks])
    every = all_gather_axes(aux, mesh, data_axes(mesh))
    grads = {}

    def record(opt, args, kwargs):
        for name, p in state.params.items():
            if "router" in name:
                grads[name] = _np(p.grad)

    state.opt_state.register_step_pre_hook(record)
    state, m = step(state, batch)
    return _rank0({"aux": aux.numpy(),
                   "aux_same_on_every_rank": bool((every == aux).all()),
                   "loss": float(m["loss"]), "router_grads": grads})


class SeededBatches:
    """Batch i is {"tokens": RandomState(seed + i).randint(0, vocab,
    (rows, cols))}, endless; a new one starts at batch 0."""

    def __init__(self, seed: int, rows: int, cols: int, vocab: int):
        self.seed, self.shape, self.vocab, self.i = seed, (rows, cols), vocab, 0

    def __iter__(self):
        return self

    def __next__(self):
        rng = np.random.RandomState(self.seed + self.i)
        self.i += 1
        return {"tokens": rng.randint(0, self.vocab, self.shape)}


def trainer_case(case: Dict[str, Any]):
    """SpmdTrainer on MeshSpec(**case["spec"]) from the case's Llama
    params: case["steps"] steps (checkpoints every case["ckpt_every"]),
    then a resume from the last checkpoint to case["resume_to"]; the
    metrics histories. The same with optimizer "adafactor" at the sizes
    of case["adafactor"] (its moments of a sharded parameter are whole
    tensors, restored as such). Then one mesh step of two fresh copies, one fed
    the global batch, one this rank's LocalBatch from
    device_put_iterator: their losses."""
    from ..data import device_put_iterator
    from ..parallel.mesh import MeshSpec
    from ..train import (RunConfig, SpmdTrainer, SpmdTrainerConfig,
                         make_optimizer, make_train_step)
    spec = MeshSpec(**case["spec"])

    def data():
        return SeededBatches(case["seed"], *case["shape"],
                             case["cfg"]["vocab_size"])

    def fit(steps, name, log_every, ckpt_every, resume=None, opt="adamw"):
        cfg = SpmdTrainerConfig(
            model=_model(case, "cpu"), mesh=spec, optimizer=opt,
            total_steps=steps, log_every=log_every,
            warmup_steps=case["warmup"], checkpoint_every=ckpt_every,
            learning_rate=case["lr"], device="cpu")
        return SpmdTrainer(cfg, data, run_config=RunConfig(
            name=name, storage_path=case["path"])).fit(resume_from=resume)

    res = fit(case["steps"], "fit", case["log_every"], case["ckpt_every"])
    res2 = fit(case["resume_to"], "resumed", case["resume_log_every"], 0,
               res.checkpoint.path)
    ada = case["adafactor"]
    ada1 = fit(ada["steps"], "ada", ada["log_every"], ada["ckpt_every"],
               opt="adafactor")
    ada2 = fit(ada["resume_to"], "ada_resumed", ada["resume_log_every"], 0,
               ada1.checkpoint.path, opt="adafactor")
    losses = []
    host = next(data())
    for local in (False, True):
        model = _model(case, "cpu")
        state, step = make_train_step(model, make_optimizer(
            "adamw", learning_rate=case["lr"]), _mesh(case["spec"]))(
            _batch(host, "cpu"))
        if local:
            batch = next(device_put_iterator(
                iter([host]), sharding=step.batch_shardings, device="cpu"))
        else:
            batch = _batch(host, "cpu")
        losses.append(float(step(state, batch)[1]["loss"]))
    return _rank0({"history": res.metrics_history,
                   "resumed": res2.metrics_history,
                   "adafactor": ada1.metrics_history,
                   "adafactor_resumed": ada2.metrics_history,
                   "checkpoint": os.path.basename(res.checkpoint.path),
                   "global_vs_local": losses,
                   "local_rows": int(batch["tokens"].shape[0])})


def ring_cases(cases: List[Dict[str, Any]]):
    """ring_attention over MeshSpec(sp=world) for each case: this rank's
    chunk of q, k, v (whole arrays in the case), the output and the
    gradients of sum(out * w), gathered whole."""
    from ..ops.ring_attention import ring_attention
    from ..parallel.collectives import all_gather_axes
    n = dist.get_world_size()
    mesh = _mesh(dict(sp=n))
    r = mesh.get_local_rank("sp")
    out = []
    for case in cases:
        def chunk(a):
            c = a.shape[1] // n
            return torch.from_numpy(a[:, r * c:(r + 1) * c].copy())
        q, k, v, w = (chunk(case[x]) for x in "qkvw")
        for t in (q, k, v):
            t.requires_grad_(True)
        o = ring_attention(q, k, v, mesh=mesh, causal=case["causal"])
        (o * w).sum().backward()
        res = {}
        for name, t in (("out", o.detach()), ("dq", q.grad),
                        ("dk", k.grad), ("dv", v.grad)):
            every = all_gather_axes(t.contiguous(), mesh, ("sp",))
            res[name] = torch.cat(list(every), dim=1).numpy()
        out.append(_rank0(res))
    return out


def pipeline_case(case: Dict[str, Any]):
    """pipeline_apply of a tanh-dense stage over MeshSpec(pp=world) with
    the whole stacked params on every rank: the output and the
    gradients of sum(out * w) in x and in the stacks (each rank's stage
    rows, summed over the ranks)."""
    from ..parallel.pipeline import pipeline_apply
    mesh = _mesh(dict(pp=dist.get_world_size()))
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    params = {k: torch.from_numpy(case[k]).requires_grad_(True)
              for k in ("w", "b")}

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = pipeline_apply(stage_fn, params, x, mesh=mesh,
                         n_microbatches=case["n_micro"])
    (out * torch.from_numpy(case["g"])).sum().backward()
    grads = [params["w"].grad, params["b"].grad]
    for g in grads:
        dist.all_reduce(g)
    return _rank0({"out": out.detach().numpy(), "dx": x.grad.numpy(),
                   "dw": grads[0].numpy(), "db": grads[1].numpy()})


def pipeline_train_case(case: Dict[str, Any]):
    """make_pipeline_train_step on MeshSpec(**case["spec"]) from the
    case's params: per step loss, then the whole params."""
    from ..models import LlamaConfig
    from ..parallel.pipeline_train import (PipelinedLM,
                                           make_pipeline_train_step,
                                           named_leaves)
    from ..train import make_optimizer
    mesh = _mesh(case["spec"])
    cfg = LlamaConfig(**case["cfg"], dtype=torch.float32,
                      param_dtype=torch.float32)
    model = PipelinedLM(cfg, mesh, n_microbatches=case["n_micro"],
                        device="cpu")
    params = {"embed": torch.from_numpy(case["params"]["embed"]),
              "stages": {k: torch.from_numpy(v)
                         for k, v in case["params"]["stages"].items()},
              "final_norm": torch.from_numpy(case["params"]["final_norm"])}
    batches = [_batch(b, "cpu") for b in case["batches"]]
    state, step = make_pipeline_train_step(
        model, make_optimizer(case["opt"], learning_rate=case["lr"]))(
        params, batches[0])
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return _rank0({"losses": losses, "params": {
        k: _np(v) for k, v in named_leaves(state.params)}})


def loader_sp_case(case: Dict[str, Any]):
    """Under MeshSpec(**case["spec"]) with sp: this rank's LocalBatch
    from device_put_iterator of case["host"] (a tokens batch of S + 1
    columns and a loss_mask of S) against the step's own cut of the
    same batch, column by column; one mesh step of two fresh copies of
    the case's model, one fed the global batch, one the LocalBatch:
    their losses; and whether a tokens batch whose S does not divide by
    sp raises ValueError."""
    from ..data import device_put_iterator
    from ..parallel.sharding import batch_sharding
    from ..train import make_optimizer, make_train_step
    mesh = _mesh(case["spec"])
    bsh = batch_sharding(mesh)
    host = case["host"]
    local = next(device_put_iterator(iter([host]), sharding=bsh,
                                     device="cpu"))
    cut = bsh.shard(_batch(host, "cpu"))
    same = (sorted(local) == sorted(cut) and all(
        torch.equal(local[k].to(cut[k].dtype), cut[k]) for k in cut))
    losses = []
    for batch in (_batch(host, "cpu"), local):
        model = _model(case, "cpu")
        state, step = make_train_step(model, make_optimizer(
            "sgd", learning_rate=0.1), mesh)(_batch(host, "cpu"))
        losses.append(float(step(state, batch)[1]["loss"]))
    try:
        bsh.shard({"tokens": torch.zeros((8, 16), dtype=torch.long)})
        raises = None
    except ValueError as e:
        raises = str(e)
    return _rank0({"same": same, "keys": sorted(local),
                   "local_shape": list(local["inputs"].shape),
                   "losses": losses, "odd_raises": raises})


def dpa_sp_case(case: Dict[str, Any]):
    """A mesh step of the case's model with attn_impl "dpa" on an sp
    mesh: the ValueError's message (None if it did not raise)."""
    from ..train import make_optimizer, make_train_step
    mesh = _mesh(case["spec"])
    model = _model({**case, "port_cfg": {"attn_impl": "dpa"}}, "cpu")
    batch = _batch(case["batches"][0], "cpu")
    state, step = make_train_step(model, make_optimizer(
        "sgd", learning_rate=0.1), mesh)(batch)
    try:
        step(state, batch)
        return _rank0(None)
    except ValueError as e:
        return _rank0(str(e))


def gpt2_tp_layout_case(case: Dict[str, Any]):
    """GPT-2 sharded on MeshSpec(**case["spec"]) (tp): each qkv
    parameter's placements, its whole tensor in `state_dict()` against
    the unsharded one, and its shape in `state_layout`; then one adamw
    step and the TrainState's `state_dict()` saved and restored onto one
    device: the qkv weight and its moments against the mesh's whole
    tensors, bit for bit."""
    from ..train import (make_optimizer, make_train_step, restore_pytree,
                         save_pytree)
    from ..train.spmd import state_layout
    mesh = _mesh(case["spec"])
    model = _model(case, "cpu")
    want = {k: torch.from_numpy(np.asarray(v))
            for k, v in case["params"].items()}
    batch = _batch(case["batches"][0], "cpu")
    state, step = make_train_step(model, make_optimizer(
        "adamw", learning_rate=1e-3), mesh)(batch)
    names = [k for k in want if ".qkv." in k]
    sd = model.state_dict()
    layout = state_layout(state)["params"]
    out = {"placements": {k: repr(tuple(sd[k].placements)) for k in names},
           "whole_equal": all(torch.equal(_whole(sd[k]), want[k])
                              for k in names),
           "layout_shapes": {k: list(layout[k].shape) for k in names}}
    state, _ = step(state, batch)
    full = state.state_dict()
    save_pytree(full, case["path"], step=1)
    back = restore_pytree(case["path"], map_location="cpu")
    order = list(state.params)
    i = order.index("h_0.qkv.weight")
    moments = full["opt_state"]["state"][i]
    out["restored_equal"] = (
        torch.equal(back["params"]["h_0.qkv.weight"],
                    _whole(full["params"]["h_0.qkv.weight"]))
        and all(torch.equal(back["opt_state"]["state"][i][m], _whole(v))
                for m, v in moments.items() if torch.is_tensor(v)
                and v.dim() > 0))
    return _rank0(out)


def ppo_mesh_case(case: Dict[str, Any]):
    """PPO with use_mesh=True in this world (MeshSpec(dp=world)) from
    case["params"] (the port's tree of the reference's init): one
    training_step on case["batch"]; its stats, the params after, and
    the learner group's mesh; and whether a group on a mesh that also
    splits rows over fsdp raises ValueError."""
    from ..rllib import LearnerGroup, PPOConfig, SampleBatch
    from ..rllib.rl_module import tree_copy_, tree_leaves
    cfg = (PPOConfig().environment(case["env"])
           .env_runners(num_envs_per_env_runner=2,
                        rollout_fragment_length=16)
           .training(**case["training"], use_mesh=True)
           .resources(device="cpu"))
    algo = cfg.build()
    tree_copy_(algo.params, case["params"])
    stats = algo.training_step(SampleBatch(case["batch"]))
    mesh = algo.learner_group.mesh
    try:
        LearnerGroup(algo.learner_group.learner,
                     mesh=_mesh(dict(dp=2, fsdp=2)))
        raises = False
    except ValueError:
        raises = True
    return _rank0({"stats": stats, "params": {
        k: v.detach().numpy() for k, v in tree_leaves(algo.params)},
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "other_data_axis_raises": raises})


def sp_and_ppo_modules():
    """One sp mesh step of a small Llama (MeshSpec(sp=world)) and one
    PPO iteration with use_mesh=True, then `foreign_modules()`."""
    from ..models import Llama, LlamaConfig
    from ..rllib import GridWorld, PPOConfig
    from ..train import make_optimizer, make_train_step
    n = dist.get_world_size()
    model = Llama(LlamaConfig.debug(dtype=torch.float32), device="cpu")
    batch = {"tokens": torch.randint(0, 256, (2, 8 * n + 1),
                                     generator=torch.Generator()
                                     .manual_seed(0))}
    state, step = make_train_step(model, make_optimizer(
        "sgd", learning_rate=0.1), _mesh(dict(sp=n)))(batch)
    step(state, batch)
    algo = (PPOConfig().environment(GridWorld)
            .env_runners(num_envs_per_env_runner=2,
                         rollout_fragment_length=8)
            .training(num_epochs=1, minibatch_size=6, use_mesh=True)
            .resources(device="cpu")).build()
    algo.train()
    return foreign_modules()


def run_jobs(jobs):
    """Several of the functions above in one world: [(name, arg), ...]
    -> their results in order."""
    return [globals()[name](arg) for name, arg in jobs]


def fail_on(rank: int):
    """Raise on `rank`; every other rank waits in a barrier it would
    never leave (the launcher must take the world down)."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()


def sleep_for(seconds: float):
    """Outlive a launcher's deadline."""
    import time
    time.sleep(seconds)


def foreign_modules() -> List[str]:
    """Modules of JAX, the JAX package or optax/flax loaded in this rank
    (none may be)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu",
                                         "optax", "flax", "orbax"))


def rank_env() -> str:
    """This rank's RAY_TPU_TRAIN_RANK, as the launcher set it."""
    from ..util import knobs  # noqa: PLC0415
    return knobs.get_raw(knobs.TRAIN_RANK)


__all__ = ["train_cases", "lora_case", "int8_forward", "checkpoint_case",
           "shard_pytree_case", "moe_aux_case", "SeededBatches",
           "trainer_case",
           "ring_cases", "pipeline_case", "pipeline_train_case",
           "loader_sp_case", "dpa_sp_case", "gpt2_tp_layout_case",
           "ppo_mesh_case", "sp_and_ppo_modules",
           "run_jobs", "fail_on", "sleep_for", "foreign_modules",
           "rank_env"]
