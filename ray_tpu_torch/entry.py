"""Entry points of the port (counterpart of `__graft_entry__`).

`entry(device="cuda")` returns (forward, example_args) for the flagship
Llama-family decoder: `forward(params, tokens)` gives the logits of the
model under `params` (a name -> tensor dict, its state_dict), and
example_args holds the model's own parameters and a (2, 128) token
batch from numpy's RandomState(0).

`dryrun_multichip(n, device="cuda")` runs the reference's multi-device
dry run on a world of n ranks (`train.backend.launch`: NCCL on n cards,
or gloo processes on the CPU): the train step over dp x fsdp x tp, LoRA
over the sharded base, ring attention over sp, Mixtral over ep, the
int8 forward over tp and the pipelined train step over pp x dp, each
with the reference's configuration and seeds; it prints one line a
stage and returns the lines.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch
from torch.func import functional_call

from .models import Llama, LlamaConfig
from .util.device import DeviceLike, resolve_device


def flagship_config() -> LlamaConfig:
    """The flagship widths: Llama-3's architecture at d 512, 4 layers,
    8/4 heads, vocab 2048."""
    return LlamaConfig(vocab_size=2048, d_model=512, n_layers=4, n_heads=8,
                       n_kv_heads=4, d_ff=1408, max_seq_len=512)


def entry(device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    cfg = flagship_config()
    model = Llama(cfg, device=dev, seed=0)
    params = dict(model.state_dict())
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)).to(dev)

    def forward(params, tokens):
        logits, _ = functional_call(model, params, (tokens,))
        return logits

    return forward, (params, tokens)


def factor(n: int):
    """n ranks as dp x fsdp x tp, innermost tp the largest factor (the
    reference's dry run's factoring)."""
    dp = 1
    if n % 2 == 0 and n > 2:
        dp, n = 2, n // 2
    fsdp = 1
    if n % 2 == 0 and n > 2:
        fsdp, n = 2, n // 2
    return dp, fsdp, n


def _tokens(seed: int, vocab: int, shape, dev) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, shape).astype(np.int64)).to(dev)


def _finite(x, what: str) -> float:
    x = float(x)
    if not math.isfinite(x):
        raise RuntimeError(f"{what}: non-finite {x}")
    return x


def _dryrun_rank(n: int, device: str) -> List[str]:
    """Every stage of the dry run on this rank; rank 0's lines."""
    import torch.distributed as dist

    from .models import Mixtral, MixtralConfig
    from .ops import ring_attention
    from .ops.quant import quantize_llama_params
    from .parallel import (MeshSpec, PipelinedLM, build_mesh,
                           make_pipeline_train_step)
    from .parallel.sharding import batch_sharding, shard_module
    from .train import (init_lora, make_lora_train_step, make_optimizer,
                        make_train_step, merge_lora)
    from .train.lora import unflatten_adapters

    kind = torch.device(device).type
    dev = (torch.device("cuda", torch.cuda.current_device())
           if kind == "cuda" else torch.device("cpu"))
    lines = []

    # ---- the train step over dp x fsdp x tp ----
    dp, fsdp, tp = factor(n)
    spec = MeshSpec(dp=dp, fsdp=fsdp, tp=tp)
    mesh = build_mesh(spec, device=kind)
    cfg = LlamaConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=8,
                      n_kv_heads=4, d_ff=192, max_seq_len=64)
    model = Llama(cfg, device=dev, seed=0)
    tx = make_optimizer("adamw", learning_rate=1e-3)
    batch = {"tokens": _tokens(0, cfg.vocab_size,
                               (2 * max(1, dp * fsdp), 32), dev)}
    state, step = make_train_step(model, tx, mesh)(batch)
    state, metrics = step(state, batch)
    loss = _finite(metrics["loss"], "train step")
    lines.append(f"dryrun_multichip ok: mesh={spec.axis_sizes()} "
                 f"loss={loss:.4f}")

    # ---- LoRA: adapter-only step over the same sharded base ----
    lora = init_lora(model, 7, rank=4, targets=("q_proj", "v_proj"))
    lstate, lstep = make_lora_train_step(model, tx, mesh=mesh)(batch, lora)
    lstate, lm = lstep(lstate, batch)
    lloss = _finite(lm["loss"], "lora step")
    merge_lora(model, {"rank": 4, "alpha": 16.0,
                       "adapters": unflatten_adapters(lstate.params)})
    lines.append(f"dryrun lora ok: adapter step over {spec.axis_sizes()} "
                 f"loss={lloss:.4f}")

    # ---- sp: ring attention over the whole world ----
    sp = n if n % 2 == 0 else 1
    sp_mesh = build_mesh(MeshSpec(sp=sp), device=kind)
    rngs = np.random.RandomState(1)
    q = rngs.randn(2, 8 * sp, 4, 16).astype(np.float32)
    kv = rngs.randn(2, 8 * sp, 2, 16).astype(np.float32)
    r = sp_mesh.get_local_rank("sp")
    ql, kvl = (torch.from_numpy(a[:, r * 8:(r + 1) * 8].copy()).to(dev)
               for a in (q, kv))
    rsum = ring_attention(ql, kvl, kvl, mesh=sp_mesh).sum()
    dist.all_reduce(rsum, group=sp_mesh.get_group("sp"))
    _finite(rsum, "ring attention")
    lines.append(f"dryrun sp ok: ring attention over sp={sp}")

    # ---- ep: MoE expert parallelism (Mixtral train step) ----
    ep = 2 if n % 2 == 0 else 1
    ep_spec = MeshSpec(dp=n // ep, ep=ep)
    ep_mesh = build_mesh(ep_spec, device=kind)
    mcfg = MixtralConfig.debug()
    mbatch = {"tokens": _tokens(2, mcfg.vocab_size, (2 * (n // ep), 16),
                                dev)}
    mstate, mstep = make_train_step(Mixtral(mcfg, device=dev, seed=1), tx,
                                    ep_mesh)(mbatch)
    mstate, mm = mstep(mstate, mbatch)
    mloss = _finite(mm["loss"], "mixtral step")
    lines.append(f"dryrun ep ok: MoE over {ep_spec.axis_sizes()} "
                 f"loss={mloss:.4f}")

    # ---- int8 serving: quantized projections sharded over tp ----
    whole = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
             for k, v in model.state_dict().items()}
    qmodel = Llama(dataclasses.replace(cfg, quant="int8"), device=dev)
    qmodel.load_state_dict(quantize_llama_params(whole))
    shard_module(qmodel, mesh)
    with torch.no_grad():
        qlogits, _ = qmodel(batch_sharding(mesh).shard(
            batch["tokens"][:, :16]))
    _finite(qlogits.float().sum(), "int8 forward")
    lines.append(f"dryrun int8 ok: quantized serving forward over "
                 f"{spec.axis_sizes()}")

    # ---- pp: the pipelined train step over a pp x dp mesh ----
    pp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    pp_dp = max(1, n // pp)
    pp_mesh = build_mesh(MeshSpec(pp=pp, dp=pp_dp), device=kind)
    pcfg = LlamaConfig(vocab_size=256, d_model=32, n_layers=pp, n_heads=2,
                       n_kv_heads=2, d_ff=64, max_seq_len=32,
                       dtype=torch.float32)
    pmodel = PipelinedLM(pcfg, pp_mesh, n_microbatches=max(2, pp),
                         device=dev)
    pbatch = {"tokens": _tokens(4, pcfg.vocab_size,
                                (2 * max(2, pp) * pp_dp, 16), dev)}
    pstate, pstep = make_pipeline_train_step(pmodel, tx)(4, pbatch)
    pstate, pm = pstep(pstate, pbatch)
    ploss = _finite(pm["loss"], "pipelined step")
    lines.append(f"dryrun pp ok: {pp}-stage pipelined train step "
                 f"(pp={pp} x dp={pp_dp}) loss={ploss:.4f}")
    return lines if dist.get_rank() == 0 else []


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda",
                     timeout_s: float = 600.0) -> List[str]:
    """The reference's dry run on a world of `n_devices` ranks (see the
    module docstring). On CUDA it takes cards 0..n-1 (a world of one
    runs in this process); on the CPU, gloo processes."""
    from .train.backend import launch
    dev = resolve_device(device)
    spawn = not (dev.type == "cuda" and n_devices == 1)
    lines = launch(_dryrun_rank, n_devices, dev.type, n_devices, dev.type,
                   timeout_s=timeout_s, spawn=spawn)[0]
    for line in lines:
        print(line, flush=True)
    return lines


__all__ = ["entry", "flagship_config", "factor", "dryrun_multichip"]
