"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterpart of ray_tpu/ops/pallas/).

- flash_attention: K1, flash-attention forward (csrc/flash_fwd.cu), and
  K2a/K2b, its backward (csrc/flash_bwd.cu), tied by an autograd
  Function.
- paged_attention: K3, paged single-token decode (csrc/paged_decode.cu).
- rmsnorm: K4, fused RMSNorm forward (csrc/rmsnorm.cu), with a backward
  through the plain math; opt-in (`fused_rms_norm`), no model calls it.
- build: compiles csrc/*.cu with nvcc on first use, loads with ctypes.

The submodules are not re-exported here, so `kernels.flash_attention`
stays the module (its function of the same name would shadow it).
"""
