"""``eval.mfu``: the model FLOPs of the window's ``evaluate()`` calls (the tower's forward and the cosines, over the real tokens, nothing recomputed), over the window's wall time, as a percent of the peak of the configuration's compute type (``peaks.json``)."""

from portbench.work import peak_share


def read(r):
    c = r.counters
    if c["kind"] != "eval" or not c.get("model_flops"):
        return None
    return peak_share(c["model_flops"], c["window_s"], r.dtype)
