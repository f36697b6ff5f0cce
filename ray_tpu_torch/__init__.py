"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute path.

`ray_tpu_torch/<path>` is the counterpart of `ray_tpu/<path>`. The JAX
package stays the reference; this package imports neither JAX nor
anything of `ray_tpu`. Every Pallas TPU kernel on a ported path is a
hand-written CUDA C++ kernel for Hopper (`csrc/`), built on first use by
`ops/kernels/build.py`. Entry points run on the GPU unless the caller
passes `device="cpu"`; a CPU tensor takes each kernel's plain PyTorch
version, a CUDA tensor launches the kernel or raises.

Ported so far: the serving slice — `ops/` (norms, activations, rotary,
attention with PagedKV), `models/llama.py` with a flax-weights
converter, and the continuous-batching engine (`serve/llm/engine.py`,
with every request control of the reference's: speculation, penalties,
guided decoding, logprobs, deadlines, the watchdog, precompile) behind
`serve.llm.LLMServer` and `serve.llm.openai_api.OpenAIServer` — and the
training slice: the flash-attention backward behind a
`torch.autograd.Function`, activation checkpointing (`remat`),
`parallel/precision.py`, and `train/` (single-device train step,
optimizers, atomic checkpoints) — and the model zoo the engine serves:
`models/{mixtral,gpt2,vit,clip,mlp}.py` on `ops/{moe,quant,linear}.py`,
int8 Llama, the `get_model` registry, flax converters for every family,
HF weight import (`train/adapters.py`) and `entry.py` — and
parallelism: one process a rank (`train/backend.py`'s `launch`), the
mesh and the rule table applied with FSDP2 and DTensor plans
(`parallel/`), the train step, LoRA and checkpoints on a mesh, ring
attention (`ops/ring_attention.py`), GPipe, Mixtral over ep and
`entry.dryrun_multichip`.
— and the runtime (`core/`, `api.py`, `dag.py`): tasks, actors, objects
and placement groups with GPU resources (`num_gpus=`, `get_gpu_ids`),
torch tensors kept on the device between tasks of one worker, and
training over rank actors (`train.TorchTrainer`, `train.MultiHostSpmd`,
`train.ElasticSpmdTrainer`) — and the front doors: `python -m
ray_tpu_torch` (`cli.py`), the dashboard, job submission, the thin
client (`init(address="ray://...")`, `client/`) and the local cluster
(`cluster_utils.py`) — and durable workflows (`workflow.py`), C++ tasks
and actors (`cross_language.py`), the gRPC ingress
(`serve/grpc_proxy.py`), shares of one card (`num_gpus=0.5`) and the
pinned attention routes (`attn_impl`, `RAY_TPU_ATTN_IMPL`,
`RAY_TPU_PAGED_ATTN_IMPL`).

The runtime loads at first use: `import ray_tpu_torch` imports no
runtime module until an API name (`init`, `remote`, ...) is read.
"""
from __future__ import annotations

import importlib

__version__ = "0.1.0"

_API = ("init", "shutdown", "is_initialized", "remote", "get", "put",
        "wait", "kill", "cancel", "get_actor", "free", "cluster_resources",
        "available_resources", "get_runtime_context", "method", "nodes",
        "timeline", "get_gpu_ids", "actor_exit")
_CORE = {"ObjectRef": "core.object_ref", "ObjectRefGenerator":
         "core.object_ref", "ActorHandle": "core.actor"}
_LAZY_SUBMODULES = ("train", "serve", "rllib", "util", "models", "ops",
                    "parallel", "observability", "dag", "data",
                    "exceptions", "tune", "job_submission", "experimental",
                    "workflow")


def __getattr__(name):
    if name in _API:
        value = getattr(importlib.import_module(".api", __name__), name)
    elif name in _CORE:
        value = getattr(importlib.import_module(f".{_CORE[name]}", __name__),
                        name)
    elif name in _LAZY_SUBMODULES:
        value = importlib.import_module(f".{name}", __name__)
    else:
        raise AttributeError(
            f"module 'ray_tpu_torch' has no attribute {name!r}")
    globals()[name] = value
    return value


__all__ = [*_API, *_CORE, *_LAZY_SUBMODULES, "__version__"]
