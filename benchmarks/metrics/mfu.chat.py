"""The whole serving step's share of the card's bf16 peak in the traced
slice: model FLOPs of what the engine dispatched in it (the program's
counters: 2 x active parameters per prompt and decode token, 4 x d a
layer per causal (query, key) pair; padding, dropped and idle rows not
counted) over the slice's seconds, over 989 TFLOP/s."""
from harness import program, roofline, serve_roofline

NEEDS = ("llm.prefill_tokens", "llm.decode_tokens", "llm.prefill_pairs",
         "llm.decode_keys")


def read(rec):
    t = rec.get("trace")
    counts = program.counters()
    if not t or rec["kind"] != "serve" or not t["window_s"] or not counts:
        return None
    counts = {k: counts.get(k, 0) for k in NEEDS}
    flops = serve_roofline.serve_flops(rec["config"], counts)
    if not flops:
        return None
    return 100.0 * flops / t["window_s"] / roofline.PEAK_BF16_FLOPS
