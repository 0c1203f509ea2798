"""``moe_encode.mfu``: Moonlight's model FLOPs in the traced unit (``reference/moonlight.py::forward_flops``: twice the parameters each real token of both tables is multiplied by, its 6 routed experts among them, and the attention over each row's real length), over the wall time of the port's ``encode.corpus`` span, as a percent of the bf16 peak (``peaks.json``)."""

from portbench.spans import recorded
from portbench.work import peak_share


def read(r):
    if r.kind != "moe_encode_eval" or r.trace is None:
        return None
    rec = recorded()
    if not rec:
        return None
    seconds = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == "encode.corpus") / 1e9
    return peak_share(r.counters["traced"]["encode_flops"], seconds, r.cell.config["encoder_dtype"]["compute_dtype"])
