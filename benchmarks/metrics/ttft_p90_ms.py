"""90th percentile of time to first token over every request due in the
window, from when it was due. A request that failed, was refused or
sent no first token before the wait ended counts as missing: its time
is at least the wait, and it is taken as that."""
from harness import stats


def read(rec):
    if rec["kind"] != "serve":
        return None
    end = rec["window_s"] + rec["traffic"]["ttft_wait_s"]
    ttft = [(end - r["due"] if r["failed"] else r["times"][0] - r["due"])
            * 1000.0 for r in rec["requests"]]
    return stats.percentile(ttft, 90) if ttft else None
