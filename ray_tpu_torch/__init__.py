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
converter, and the paged continuous-batching engine
(`serve/llm/engine.py`) behind `serve.llm.LLMServer` — and the training
slice: the flash-attention backward behind a `torch.autograd.Function`,
activation checkpointing (`remat`), `parallel/precision.py`, and
`train/` (single-device train step, optimizers, atomic checkpoints).
"""
