"""``article_encode.mfu``: Kimi-Linear's model FLOPs in the traced unit (``reference/kimi_linear.py::forward_flops``: twice the parameters each real token of both tables is multiplied by, the held experts' pairs from the port's counter ``moe.assignments_held``, the KDA recurrence in its chunk-64 form and MLA over each row's real length), over the wall time of the port's ``encode.corpus`` span, as a percent of the bf16 peak (``peaks.json``)."""

from portbench.spans import recorded
from portbench.work import peak_share


def read(r):
    if r.kind != "article_encode_eval" or r.trace is None:
        return None
    rec = recorded()
    flops = r.counters["traced"].get("encode_flops")
    if not rec or not flops:
        return None
    seconds = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == "encode.corpus") / 1e9
    return peak_share(flops, seconds, r.cell.config["encoder_dtype"]["compute_dtype"])
