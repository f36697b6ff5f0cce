"""Share of the traced slice with no operation running on the device."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["window_s"] or rec["kind"] != "serve":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
