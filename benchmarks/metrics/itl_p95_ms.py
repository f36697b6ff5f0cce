"""95th percentile of every gap between consecutive output tokens of
every request, over the gaps that end inside the window."""
from harness import stats


def read(rec):
    if rec["kind"] != "serve":
        return None
    w = rec["window_s"]
    gaps = [(b - a) * 1000.0 for r in rec["requests"]
            for a, b in zip(r["times"], r["times"][1:]) if b <= w]
    return stats.percentile(gaps, 95) if gaps else None
