"""Plain PyTorch references of the benchmark's model families.

Float32, TF32 off (the callers switch it off around them), no kernels,
no cache, no batching: each follows the published layer equations and
imports nothing of the port. Weights come from `harness.weights`, made
again from the seed group by group.
"""
