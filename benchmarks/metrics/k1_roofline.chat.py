"""K1 (csrc/flash_fwd.cu) against its roofline in serving: for each
shape the program counted K1 launches at in the traced slice
(`k1.launch:B,S,Hq,Hkv,D,causal`, the prefill groups' padded buckets),
the count times the least time one launch could take, summed, over the
device time of the `flash_fwd` kernels in the slice."""
from harness import program, roofline
from harness.trace import kernel_time


def read(rec):
    t = rec.get("trace")
    counts = program.counters()
    if not t or rec["kind"] != "serve" or not counts:
        return None
    launches = program.k1_launches(counts)
    _, secs = kernel_time(t, "flash_fwd")
    if not launches or not secs:
        return None
    bound = sum(n * roofline.bound_s(*roofline.k1_cost(*shape))
                for n, shape in launches)
    return 100.0 * bound / secs
