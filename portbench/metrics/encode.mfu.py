"""``encode.mfu``: the news encoder's model FLOPs in the traced unit (``reference/nvembed.py::forward_flops``: the backbone's and the head's products over the real tokens of both tables, the self-attention over each row's real length, the latents' keys and values once a head call), over the wall time of the port's ``encode.corpus`` span, as a percent of the peak of the encoder's compute type (``peaks.json``)."""

from portbench.spans import recorded
from portbench.work import peak_share


def read(r):
    if r.kind != "encode_eval" or r.trace is None:
        return None
    rec = recorded()
    if not rec:
        return None
    seconds = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == "encode.corpus") / 1e9
    dtype = r.cell.config["encoder_dtype"]["compute_dtype"]
    return peak_share(r.counters["traced"]["encode_flops"], seconds, dtype)
