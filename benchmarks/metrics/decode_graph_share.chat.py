"""The share of the traced slice's one-token decode steps that replayed
a captured CUDA graph rather than issuing the forward's operations from
Python: the program's `llm.decode_graph_steps` over it plus
`llm.decode_eager_steps`, in %. A program that counts neither gives
None."""
from harness import program


def read(rec):
    counts = program.counters()
    if rec["kind"] != "serve" or not counts:
        return None
    graph = counts.get("llm.decode_graph_steps", 0)
    steps = graph + counts.get("llm.decode_eager_steps", 0)
    return 100.0 * graph / steps if steps else None
