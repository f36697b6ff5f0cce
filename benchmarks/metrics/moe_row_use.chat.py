"""The share of the rows the experts computed in the traced slice that
a token was routed to: k x layers x (prompt + decode tokens the engine
dispatched) over the program's `moe.rows_computed` (E x the batch's
slots a MoE call: at the cell's dropless capacity every expert runs
every row of the padded bucket or of all the slots)."""
from harness import program


def read(rec):
    counts = program.counters()
    if rec["kind"] != "serve" or not counts \
            or not counts.get("moe.rows_computed"):
        return None
    c = rec["config"]
    routed = c["num_experts_per_tok"] * c["num_hidden_layers"] * (
        counts.get("llm.prefill_tokens", 0)
        + counts.get("llm.decode_tokens", 0))
    return 100.0 * routed / counts["moe.rows_computed"]
