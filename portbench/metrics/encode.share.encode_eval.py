"""``encode.share.encode_eval``: the percent of the traced encode-then-rank unit's wall time (the driver's host clock around it) that the port's ``encode.corpus`` span takes (``encode_query_and_passage``: tokenizing and encoding both tables)."""

from portbench.spans import recorded


def read(r):
    if r.kind != "encode_eval" or r.trace is None:
        return None
    rec, unit_s = recorded(), r.counters["traced"]["unit_s"]
    if not rec or unit_s <= 0:
        return None
    seconds = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == "encode.corpus") / 1e9
    return 100.0 * seconds / unit_s if seconds > 0 else None
