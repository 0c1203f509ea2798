"""Encode whole articles, then rank, with a hybrid linear-attention LLM
embedder: ``moe_encode_eval``'s unit (``drivers/moe_encode_eval.py``, whose
code this driver takes by import) with Kimi-Linear-48B-A3B as this card's
share of a two-card expert-parallel deployment.

A unit encodes the configuration's ``news`` articles into both tables with
``ops.encode.encode_query_and_passage`` (query rows BOS, the instruction,
the article and EOS; passage rows BOS, the article and EOS; every row pooled
at its last real token; rows bucketed up to ``token_width``), then ranks the
``dev_rows`` impressions over them with the user tower's flat eval. An
article's length is log-normal (``articles``: median and sigma, clipped),
drawn from a fixed stream in an order of the seed's own, so every run does
the same work; its ids are uniform below BOS. The encoder's configuration is
the ``config.json`` at the top level of the configuration file, with its
``num_experts`` (the experts held here) read from ``published`` for the
router's width and ``deployment.experts_held`` given to the program. Set-up
builds the encoder's configuration first, so a program without the layout
stops there, before any weight is drawn.

After the window the reference checks the last timed unit, as the Moonlight
cell does, on ``sample_rows`` rows of each table (every bucket present, the
unit's longest row among them, and a row that ends just past a multiple of
1,024 tokens): ``embed_gap`` and ``route_mismatch``
against the plain float32 Kimi-Linear (``reference/kimi_linear.py``, on the
program's bfloat16 weights, its KDA one token at a time, the program's
picks of experts applied), then ``score_gap`` and ``metric_gap``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import check, generate, weights
from portbench.drivers import moe_encode_eval
from portbench.drivers.encode_eval import embed_gap
from portbench.reference import kimi_linear
from portbench.reference.common import Precision, float32_matmuls
from portbench.spans import recorded

eval_driver = moe_encode_eval.eval_driver
LONG_STATE = 1024  # tokens: the sample holds a row just past a multiple of it (``sample``)


def full_config(cfg: dict) -> dict:
    """The encoder's ``config.json`` as published: ``num_experts`` the
    router's width."""
    return dict(cfg, num_experts=cfg["published"]["num_experts"])


class Driver(moe_encode_eval.Driver):
    def __init__(self, cell, seed: int, seconds: float, device, trace: bool):
        super().__init__(cell, seed, seconds, device, trace)
        self.hf = full_config(self.cfg)
        self.held = tuple(self.cfg["deployment"]["experts_held"])

    def texts(self) -> tuple[list[str], str]:
        """The unit's articles and the instruction, as decimal ids below
        BOS."""
        a = self.traffic["articles"]
        n, top = self.cfg["news"], self.hf["bos_token_id"]
        sizes = generate.seed_rng(0, 97)
        lens = np.exp(np.log(a["median_tokens"]) + a["sigma"] * sizes.standard_normal(n))
        lens = np.clip(np.rint(lens), a["min_tokens"], a["max_tokens"]).astype(np.int64)
        rng = generate.seed_rng(self.seed, 4)
        lens = lens[rng.permutation(n)]
        ids = rng.integers(3, top, size=int(lens.sum()))
        instruction = rng.integers(3, top, size=self.traffic["instruction_tokens"])
        ends = np.cumsum(lens)
        articles = [" ".join(map(str, ids[e - k : e])) for k, e in zip(lens, ends)]
        return articles, " ".join(map(str, instruction)) + " "

    def encoder_params(self) -> dict[str, torch.Tensor]:
        """This card's share of the encoder's weights on the device in its
        parameter type, drawn from the seed one parameter at a time
        (``kimi_linear.draw``)."""
        dt = getattr(torch, self.cfg["encoder_dtype"]["param_dtype"])
        gen = weights.device_generator(self.seed, 5, self.device)
        return kimi_linear.draw(self.hf, gen, self.device, dt, self.held)

    def _encoder(self):
        from news_recommendation_project_v2_torch.models.news_encoder import NewsEncoder, encoder_config_from_hf

        cfg = encoder_config_from_hf(self.hf, max_length=self.cfg["token_width"], experts_held=self.held,
                                     **self.cfg["encoder_dtype"])
        with torch.device("meta"):
            enc = NewsEncoder(cfg)
        enc.load_state_dict(self.params, assign=True)
        return enc.eval()

    def setup(self) -> None:
        from news_recommendation_project_v2_torch.models.news_encoder import encoder_config_from_hf

        encoder_config_from_hf(self.hf, experts_held=self.held)  # the layout first: without it the run stops here
        super().setup()

    def readings(self) -> dict:
        _, q_mask, _, _, p_mask = self.tables_tokens()
        lens = np.concatenate([q_mask.sum(1), p_mask.sum(1)])
        rec = recorded()
        held_pairs = rec.counters.get("moe.assignments_held", 0) if rec else 0
        return {
            "kind": "article_encode_eval",
            "window_s": self.window_s,
            "traced": {
                "unit_s": self.traced_s,
                "tokens": self.tokens,
                "encode_tokens": float(lens.sum()),
                "held_pairs": float(held_pairs),
                "encode_flops": kimi_linear.forward_flops(self.hf, lens, held_pairs) if held_pairs else None,
            },
        }

    # -- the reference ----------------------------------------------------------

    def sample(self, mask: np.ndarray, stream: int) -> np.ndarray:
        """``sample_rows`` rows (ascending) drawn from the seed: one of each
        bucket the rows fall in and the longest row among them; besides
        them, the row of over ``LONG_STATE`` tokens whose last token lies
        nearest past a multiple of ``LONG_STATE``, where a state lost at such
        a multiple would reach the pooled output within a few tokens."""
        from news_recommendation_project_v2_torch.ops.encode import TOKEN_BUCKETS

        rng = generate.seed_rng(self.seed, stream)
        width = mask.shape[1]
        lens = mask.sum(1)
        widths = np.asarray(sorted({b for b in TOKEN_BUCKETS if b < width}) + [width])
        bucket = np.searchsorted(widths, lens, side="left")
        first = {int(np.argmax(lens))} | {int(rng.choice(np.flatnonzero(bucket == b))) for b in np.unique(bucket)}
        rest = rng.permutation(np.setdiff1d(np.arange(len(mask)), sorted(first)))
        take = max(0, self.traffic["sample_rows"] - len(first))
        rows = set(first) | set(rest[:take].tolist())
        long = np.flatnonzero(lens > LONG_STATE)
        if len(long):
            rows.add(int(long[np.argmin((lens[long] - 1) % LONG_STATE)]))
        return np.asarray(sorted(rows), dtype=np.int64)

    def reference_samples(self, routes: list | None = None, forced: list | None = None, **control) -> list:
        """Each table's sampled rows and the reference's unit vectors of them:
        ``(rows, [rows, D])`` for the query table, then the passage table,
        all rows of both in one pass (``kimi_linear.encode_rows``).
        ``routes`` gets the reference's own picks, ``forced`` the picks it
        applies; ``control`` alters the reference (the controls')."""
        float32_matmuls()
        rows, cuts = [], []
        for ids, mask, sampled in self.sampled_tables():
            for r in sampled:
                n = int(mask[r].sum())
                rows.append(torch.from_numpy(np.ascontiguousarray(ids[r, :n])).to(self.device))
            cuts.append(sampled)
        vecs = kimi_linear.encode_rows(self.params, self.hf, rows, self.held, routes=routes, forced=forced, **control)
        return [(cuts[0], vecs[: len(cuts[0])]), (cuts[1], vecs[len(cuts[0]) :])]

    def check(self) -> list[dict]:
        limits = self.cell.limits
        if self.last is None:
            return [
                check.entry("embed_gap", float("inf"), limits["embed_gap"]),
                check.entry("route_mismatch", float("inf"), limits["route_mismatch"]),
            ] + eval_driver.numbers(None, [], None, None, limits)
        t0 = time.perf_counter()
        last = self.last
        got_routes = self.routes.picks(self.sampled_tables())
        self.routes.calls = []
        want_routes: list = []
        samples = self.reference_samples(routes=want_routes, forced=got_routes)
        gap = embed_gap((last.query, last.passage), samples)
        mismatch = moe_encode_eval.route_mismatch(got_routes, want_routes)
        ref = self.rank_reference(last.query, last.passage, Precision("float32"))
        got = last.scores.double().cpu().numpy()
        print(f"article_encode_eval: the check took {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        return [
            check.entry("embed_gap", gap, limits["embed_gap"]),
            check.entry("route_mismatch", mismatch, limits["route_mismatch"]),
        ] + eval_driver.numbers(got, [last.metrics], ref["scores"], self._data(), limits)
