"""The benchmark harness of the PyTorch and CUDA port (`ray_tpu_torch`).

Everything here is the yardstick: traffic generation, seeded weights,
percentile and roofline arithmetic, the trace reduction and the
comparison that decides `correct`. The port is imported only by the
runners (`serve.py`, `train.py`) and the per-family constructors under
`benchmarks/models/`; the plain references under
`benchmarks/reference/` import nothing of it.
"""
