"""K3 (csrc/paged_decode.cu) against its roofline in serving: the least
time to read the keys the traced slice's decode steps needed (the
program's `llm.decode_keys`, each active slot's length after each step,
once a layer; K and V in bf16), over the device time of K3's launches
in the slice (`paged_decode_kernel` and, where a sequence's keys are
split, `paged_merge_kernel`)."""
from harness import program, roofline, serve_roofline
from harness.trace import kernel_time


def read(rec):
    t = rec.get("trace")
    counts = program.counters()
    if not t or rec["kind"] != "serve" or not counts \
            or not counts.get("llm.decode_keys"):
        return None
    secs = kernel_time(t, "paged_decode")[1] + kernel_time(
        t, "paged_merge")[1]
    if not secs:
        return None
    c = rec["config"]
    hq, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    keys = counts["llm.decode_keys"] * c["num_hidden_layers"]
    bound = roofline.bound_s(*serve_roofline.k3_cost(
        keys, hq, hkv, c["hidden_size"] // hq))
    return 100.0 * bound / secs
