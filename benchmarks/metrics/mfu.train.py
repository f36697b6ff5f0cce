"""The whole step's share of the card's bf16 peak: model FLOPs of a step
(6 x matmul parameters x tokens plus causal attention, recomputation
not counted) times the window's steps over the window, over 989
TFLOP/s."""
from harness import roofline


def read(rec):
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    mix = rec["traffic"]
    flops = roofline.train_step_flops(rec["config"], mix["batch"],
                                      mix["seq_len"])
    return 100.0 * flops * rec["steps"] / rec["window_s"] \
        / roofline.PEAK_BF16_FLOPS
