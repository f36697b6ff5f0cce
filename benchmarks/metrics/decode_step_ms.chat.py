"""The engine's host loop: the window's time over the decode steps it
drained in it (`LLMEngine.get_stats()["decode_steps"]`, read at the
open and at the close, or where a traced run starts its slice)."""


def read(rec):
    steps = rec.get("counters", {}).get("decode_steps", 0)
    return rec["counted_s"] * 1000.0 / steps if steps else None
