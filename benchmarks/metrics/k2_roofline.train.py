"""K2a and K2b (csrc/flash_bwd.cu) together against their rooflines at
the cell's shape: each kernel's launches times its least time, summed,
over the device time of both."""
from harness import roofline
from harness.trace import kernel_time


def read(rec):
    t = rec.get("trace")
    if not t or rec["kind"] != "train":
        return None
    na, ta = kernel_time(t, "bwd_dq")
    nb, tb = kernel_time(t, "bwd_dkv")
    if not (na and nb and ta + tb):
        return None
    c, mix = rec["config"], rec["traffic"]
    h = c["num_attention_heads"]
    shape = (mix["batch"], mix["seq_len"], h, c["num_key_value_heads"],
             c["hidden_size"] // h)
    bound = na * roofline.bound_s(*roofline.k2a_cost(*shape)) \
        + nb * roofline.bound_s(*roofline.k2b_cost(*shape))
    return 100.0 * bound / (ta + tb)
