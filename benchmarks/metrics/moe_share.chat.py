"""The MoE layer's share of the device's busy time in the traced slice:
device time of the operations launched inside `MoEMLP.forward` (the
harness's `bench.moe` ranges) over the union of all device operations."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["busy_s"] or not t["ranges"].get("bench.moe"):
        return None
    return 100.0 * t["ranges"]["bench.moe"] / t["busy_s"]
