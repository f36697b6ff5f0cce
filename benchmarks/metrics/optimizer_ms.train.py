"""Device time a step of the operations launched inside the optimizer's
own `Optimizer.step#...` range, over the steps of the traced slice."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("steps"):
        return None
    secs = sum(v for k, v in t["ranges"].items()
               if k.startswith("Optimizer.step#"))
    return 1000.0 * secs / t["steps"] if secs else None
