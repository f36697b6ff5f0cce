"""K1 (csrc/flash_fwd.cu) against its roofline at the cell's shape: its
launches in the traced slice times the least time one launch could take
(causal, the configuration's heads, the mix's batch and sequence), over
the device time of those launches."""
from harness import roofline
from harness.trace import kernel_time


def read(rec):
    t = rec.get("trace")
    if not t or rec["kind"] != "train":
        return None
    n, secs = kernel_time(t, "flash_fwd")
    if not n or not secs:
        return None
    c, mix = rec["config"], rec["traffic"]
    h = c["num_attention_heads"]
    bound = roofline.bound_s(*roofline.k1_cost(
        mix["batch"], mix["seq_len"], h, c["num_key_value_heads"],
        c["hidden_size"] // h))
    return 100.0 * n * bound / secs
