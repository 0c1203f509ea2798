"""``geglu_roofline.train``: the GEGLU feed-forward kernel's share of its roofline over the traced window: the least time the card could take for the work of the window's real tokens (the larger of operations over the peak and bytes over the bandwidth, ``work.geglu_work``), over the device time of every launch whose kernel name holds ``geglu_``."""

from portbench.work import geglu_work, roofline_share


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    c = r.counters["traced"]
    if not c.get("calls"):
        return None
    ops, nbytes = geglu_work(r.tower, c["tokens"], int(c["calls"]))
    return roofline_share(ops, nbytes, r.trace.seconds("geglu_"), r.dtype)
