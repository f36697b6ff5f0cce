"""Tokens of every step in the window over the time from its open to
the end of its last step (each step ends in a read of its loss)."""


def read(rec):
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    return rec["tokens"] / rec["window_s"]
