"""Attention's share of the device's busy time in the traced slice:
device time of the operations launched inside the program's `attn`
spans (models/llama.py `LlamaAttention.forward`, which Mixtral shares:
the projections, RoPE, the KV writes, K1 in prefill and K3 in decode)
over the union of all device operations."""


def read(rec):
    t = rec.get("trace")
    if not t or rec["kind"] != "serve" or not t["busy_s"]:
        return None
    secs = t["ranges"].get("attn")
    return 100.0 * secs / t["busy_s"] if secs else None
