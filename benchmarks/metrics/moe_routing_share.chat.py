"""The MoE layer's work around the experts as a share of the device's
busy time in the traced slice: device time of the operations launched
inside the program's `moe.route` (router product, top-k, queue
positions), `moe.dispatch`, `moe.combine` and `moe.aux` spans
(models/mixtral.py, ops/moe.py) over the union of all device
operations."""

SPANS = ("moe.route", "moe.dispatch", "moe.combine", "moe.aux")


def read(rec):
    t = rec.get("trace")
    if not t or rec["kind"] != "serve" or not t["busy_s"]:
        return None
    secs = sum(t["ranges"].get(s, 0.0) for s in SPANS)
    return 100.0 * secs / t["busy_s"] if secs else None
