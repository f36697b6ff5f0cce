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
"""
