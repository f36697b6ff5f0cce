"""The experts' share of the device's busy time in the traced slice:
device time of the operations launched inside the program's
`moe.experts` spans (ops/moe.py: the experts' three bmm and SwiGLU over
their E x C rows) over the union of all device operations."""


def read(rec):
    t = rec.get("trace")
    if not t or rec["kind"] != "serve" or not t["busy_s"]:
        return None
    secs = t["ranges"].get("moe.experts")
    return 100.0 * secs / t["busy_s"] if secs else None
