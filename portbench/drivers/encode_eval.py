"""Encode, then rank: a batch of fresh news through the news encoder into
its two tables, then the impressions over them through the user tower's
flat eval, back to back.

A unit encodes the configuration's ``news`` titles with
``ops.encode.encode_query_and_passage`` (bucketed by ``TOKEN_BUCKETS``, the
memory model's batches): query rows are BOS, the instruction, the title and
EOS, with the instruction out of the pool; passage rows BOS, the title and
EOS. The tower's trainer takes the new tables in place of the old
(``TowerTrainer.set_tables``) and ``evaluate()`` ranks the ``dev_rows``
impressions, histories read from the query table and candidates from the
passage table, the MIND metrics on the card. Set-up builds everything and
runs one whole unit (plans, kernel builds, every shape);
``eval_impressions_per_s`` is the impressions of the window's whole units
over their wall time.

Titles are token ids drawn from the seed: a length of ``min_tokens`` plus
a Poisson count (``mean_extra``), capped at ``max_tokens``, from a fixed
stream in an order of the seed's own (every run does the same work), ids
uniform over the vocabulary past its three special ids; the instruction is
``instruction_tokens`` ids from the seed, the same on every row. A text is
its ids in decimal, and ``IdTokenizer`` reads them back.

After the window the reference checks what the last timed unit produced:
``embed_gap``, the largest L2 distance between the program's unit vectors
and the plain float32 NV-Embed's (``reference/nvembed.py``, on the
program's own bfloat16 weights) over a seeded sample of rows of each table
(every bucket present); ``score_gap`` and ``metric_gap`` against the
reference tower over the program's own tables, as the eval cell checks.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import check, generate, port, weights
from portbench.drivers import eval as eval_driver
from portbench.reference import metrics as ref_metrics
from portbench.reference import nvembed
from portbench.reference import scoring as ref_scoring
from portbench.reference.common import Precision, float32_matmuls
from portbench.trace import traced

METRICS = eval_driver.METRICS
BOS, EOS, PAD = 1, 2, 0  # Mistral's BOS and EOS; pads are masked
SAMPLE_ROWS = 256  # rows of each table the reference encodes
REF_BLOCK = 32  # rows a reference block


class IdTokenizer:
    """Texts of decimal token ids -> [B, width] int32 ids and mask: BOS, the
    ids (as many as fit), EOS, then pads. The texts are parsed in one pass
    (a Python loop over the ids cost the card ~68 ms of idle a unit, and
    its share of the unit moved with the host's load)."""

    def __init__(self, width: int):
        self.width = width

    def __call__(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        flat = np.fromstring("".join(t + " -1 " for t in texts), dtype=np.int64, sep=" ")
        ends = np.flatnonzero(flat < 0)  # each text closed by a -1
        starts = np.concatenate([[0], ends[:-1] + 1])[: len(ends)]
        keep = np.minimum(ends - starts, self.width - 2)
        cols = np.arange(self.width)[None, :]
        body = (cols >= 1) & (cols <= keep[:, None])
        ids = np.full((len(texts), self.width), PAD, np.int32)
        ids[body] = flat[(starts[:, None] + cols - 1)[body]]
        ids[:, 0] = BOS
        ids[np.arange(len(texts)), keep + 1] = EOS
        mask = (cols < keep[:, None] + 2).astype(np.int32)
        return ids, mask


@dataclasses.dataclass
class Unit:
    """What one unit produced: the tables, the eval's scores and metrics."""

    query: torch.Tensor
    passage: torch.Tensor
    scores: torch.Tensor
    metrics: dict


class Driver:
    def __init__(self, cell, seed: int, seconds: float, device, trace: bool):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.hf = self.cfg["encoder"]
        self.seed = int(seed) % 2**63
        self.device = torch.device(device)
        self.trace = trace
        self.tower_mod = cell.reference()
        self.tokenize = IdTokenizer(self.cfg["token_width"])
        self.calls = {"window": 0, "traced": 0}
        self.head_calls = {"window": 0, "traced": 0}
        self.phase = "setup"
        self.window_s = self.traced_s = 0.0
        self.unit_s: list[float] = []
        self.results: list[dict] = []
        self.last: Unit | None = None
        self.scores = None

    # -- inputs -----------------------------------------------------------

    def _data(self) -> generate.Behaviors:
        return generate.behaviors(
            generate.seed_rng(self.seed, 1), self.cfg[self.traffic["rows"]], self.cfg["news"], self.traffic["behaviors"]
        )

    def texts(self) -> tuple[list[str], str]:
        """The unit's titles and the instruction, as decimal ids."""
        t = self.traffic["titles"]
        n, vocab = self.cfg["news"], self.hf["text_config"]["vocab_size"]
        sizes = generate.seed_rng(0, 98)
        lens = np.minimum(t["min_tokens"] + sizes.poisson(t["mean_extra"], size=n), t["max_tokens"])
        rng = generate.seed_rng(self.seed, 4)
        lens = lens[rng.permutation(n)]
        ids = rng.integers(3, vocab, size=int(lens.sum()))
        instruction = rng.integers(3, vocab, size=self.traffic["instruction_tokens"])
        ends = np.cumsum(lens)
        titles = [" ".join(map(str, ids[e - k : e])) for k, e in zip(lens, ends)]
        return titles, " ".join(map(str, instruction)) + " "

    def encoder_params(self) -> dict[str, torch.Tensor]:
        """The encoder's weights on the device in its parameter type, drawn
        from the seed one parameter at a time (``weights.make_params``'
        rules)."""
        dt = getattr(torch, self.cfg["encoder_dtype"]["param_dtype"])
        gen = weights.device_generator(self.seed, 5, self.device)
        return {
            name: weights.make_params({name: spec}, gen, self.device)[name].to(dt)
            for name, spec in nvembed.param_shapes(self.hf).items()
        }

    def inputs(self) -> None:
        """The encoder's and the tower's weights, from the seed, on the
        device."""
        dev = self.device
        self.params = self.encoder_params()
        self.init = weights.make_params(
            self.tower_mod.param_shapes(self.cfg["tower"]), weights.device_generator(self.seed, 3, dev), dev
        )

    # -- the program --------------------------------------------------------

    def _encoder(self):
        from news_recommendation_project_v2_torch.models.news_encoder import NewsEncoder, encoder_config_from_hf

        cfg = encoder_config_from_hf(self.hf, max_length=self.cfg["token_width"], **self.cfg["encoder_dtype"])
        with torch.device("meta"):
            enc = NewsEncoder(cfg)
        enc.load_state_dict(self.params, assign=True)
        return enc.eval()

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        data = self._data()
        self.rows = data.rows
        self.tokens = float(np.minimum(data.hist_lens, cfg["history_cap"]).sum())
        self.titles, self.instruction = self.texts()
        self.inputs()
        from news_recommendation_project_v2_torch.ops.encode import TOKEN_BUCKETS
        from news_recommendation_project_v2_torch.train.trainer import TowerTrainer

        self.buckets = TOKEN_BUCKETS
        self.encoder = self._encoder()
        self.tower = port.build_tower(cfg, self.init, dev)
        if self.trace:
            self.tower.register_forward_hook(lambda *_: self._count(self.calls))
            self.encoder.latent_pool.register_forward_hook(lambda *_: self._count(self.head_calls))
        query, passage = self._encode()
        self.trainer = TowerTrainer(
            self.tower, port.compiled(data, cfg["news"]), passage, query_news_emb_train=query,
            cfg=port.train_config(cfg, self.seed), flat_train=cfg["flat_train"], flat_eval=cfg["flat_eval"],
            device_metrics=True, device=dev,
        )
        self.trainer.evaluate()  # the eval's plans built, the first unit whole
        self._capture_scores()

    def _count(self, calls: dict) -> None:
        if self.phase in calls:
            calls[self.phase] += 1

    def _encode(self) -> tuple[torch.Tensor, torch.Tensor]:
        from news_recommendation_project_v2_torch.ops.encode import encode_query_and_passage

        return encode_query_and_passage(
            self.encoder, self.tokenize, self.titles, self.instruction, batch_size=None, buckets=self.buckets,
            device=self.device,
        )

    def _rank(self, query: torch.Tensor, passage: torch.Tensor) -> dict:
        self.trainer.set_tables(passage, query_news_emb_train=query)
        return self.trainer.evaluate()[0]

    def _capture_scores(self) -> None:
        """Keep the cosine scores of each ``evaluate()``, on the device, as its
        flat eval plan hands them to the metrics (no copy, no wait)."""
        fplan, _ = next(iter(self.trainer._fused_plans.values()))
        scores = fplan._scores

        def kept(*args, **kwargs):
            self.scores = scores(*args, **kwargs)
            return self.scores

        fplan._scores = kept

    def _unit(self) -> dict:
        """Encode the news, then rank the impressions; the metrics fetched
        end it. What a unit outside the traced one produced is kept for the
        check."""
        query, passage = self._encode()
        metrics = self._rank(query, passage)
        if self.phase != "traced":
            self.last = Unit(query, passage, self.scores, metrics)
        return metrics

    # -- the harness's calls -------------------------------------------------

    def window(self, seconds: float) -> tuple[dict, int, int]:
        self.phase = "window"
        failed = 0
        t0 = last = time.perf_counter()
        while True:
            metrics = self._unit()
            self.results.append(metrics)
            failed += not all(np.isfinite(metrics[k]) for k in METRICS)
            now = time.perf_counter()
            self.unit_s.append(now - last)
            last = now
            if now - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        n = len(self.results)
        return {"eval_impressions_per_s": self.rows * n / self.window_s}, n, failed

    def traced(self, out: list) -> None:
        self.phase = "traced"
        t0 = time.perf_counter()
        with traced(out):
            self._unit()
        self.traced_s = time.perf_counter() - t0

    def readings(self) -> dict:
        _, q_mask, _, _, p_mask = self.tables_tokens()
        lens = np.concatenate([q_mask.sum(1), p_mask.sum(1)])
        return {
            "kind": "encode_eval",
            "window_s": self.window_s,
            "traced": {
                "unit_s": self.traced_s,
                "tokens": self.tokens,
                "calls": self.calls["traced"],
                "head_calls": self.head_calls["traced"],
                "head_tokens": float(lens.sum()),
                "encode_flops": nvembed.forward_flops(self.hf, lens, self.head_calls["traced"]),
            },
        }

    def release(self) -> None:
        """The program's state goes; its weights (the reference's) and the
        last timed unit's output stay."""
        self.trainer = self.tower = self.encoder = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------------

    def tables_tokens(self):
        """The two tables' token rows as the traffic lays them out: query
        ids, mask and pool mask (BOS and the instruction out), then passage
        ids and mask."""
        q_ids, q_mask = self.tokenize([self.instruction + t for t in self.titles])
        p_ids, p_mask = self.tokenize(self.titles)
        q_pool = q_mask.copy()
        q_pool[:, : 1 + self.traffic["instruction_tokens"]] = 0
        return q_ids, q_mask, q_pool, p_ids, p_mask

    def sample(self, mask: np.ndarray, stream: int) -> np.ndarray:
        """``SAMPLE_ROWS`` rows (ascending) drawn from the seed, one of each
        bucket the rows fall in among them."""
        from news_recommendation_project_v2_torch.ops.encode import TOKEN_BUCKETS

        rng = generate.seed_rng(self.seed, stream)
        width = mask.shape[1]
        widths = np.asarray(sorted({b for b in TOKEN_BUCKETS if b < width}) + [width])
        bucket = np.searchsorted(widths, mask.sum(1), side="left")
        first = [rng.choice(np.flatnonzero(bucket == b)) for b in np.unique(bucket)]
        rest = rng.permutation(np.setdiff1d(np.arange(len(mask)), first))
        return np.sort(np.concatenate([first, rest[: max(0, SAMPLE_ROWS - len(first))]])).astype(np.int64)

    @torch.no_grad()
    def reference_rows(self, ids, mask, pool, rows, **control) -> torch.Tensor:
        """The reference's unit vectors of ``rows``, in blocks of rows cut to
        their longest."""
        out = []
        for s in range(0, len(rows), REF_BLOCK):
            r = rows[s : s + REF_BLOCK]
            w = int(mask[r].sum(1).max())
            t = [torch.from_numpy(np.ascontiguousarray(a[r, :w])).to(self.device) for a in (ids, mask, pool)]
            out.append(nvembed.encode(self.params, self.hf, *t, **control))
        return torch.cat(out)

    def reference_samples(self, pool_instruction: bool = False, **control) -> list:
        """Each table's sampled rows and the reference's unit vectors of them:
        ``(rows, [rows, D])`` for the query table, then the passage table.
        ``pool_instruction`` and ``control`` alter the reference (the
        controls')."""
        float32_matmuls()
        q_ids, q_mask, q_pool, p_ids, p_mask = self.tables_tokens()
        out = []
        for ids, mask, pool, stream in ((q_ids, q_mask, q_mask if pool_instruction else q_pool, 6),
                                        (p_ids, p_mask, p_mask, 7)):
            rows = self.sample(mask, stream)
            out.append((rows, self.reference_rows(ids, mask, pool, rows, **control)))
        return out

    def rank_reference(self, query: torch.Tensor, passage: torch.Tensor, prec: Precision) -> dict:
        """The reference tower's slot scores over the tables, and the MIND
        metrics of them."""
        float32_matmuls()
        cfg, data = self.cfg, self._data()
        users = ref_scoring.user_vectors(
            self.tower_mod, self.init, cfg["tower"], query, data.hist_rev, data.hist_lens, cfg["history_cap"], prec
        )
        scores = ref_scoring.slot_scores(users, passage, data.imp_rev, data.imp_lens)
        return {"scores": scores, "metrics": ref_metrics.mind_metrics(scores, data.labels, data.imp_lens)}

    def check(self) -> list[dict]:
        limits = self.cell.limits
        if self.last is None:
            return [check.entry("embed_gap", float("inf"), limits["embed_gap"])] + eval_driver.numbers(
                None, [], None, None, limits
            )
        last = self.last
        gap = embed_gap((last.query, last.passage), self.reference_samples())
        ref = self.rank_reference(last.query, last.passage, Precision("float32"))
        got = last.scores.double().cpu().numpy()
        return [check.entry("embed_gap", gap, limits["embed_gap"])] + eval_driver.numbers(
            got, [last.metrics], ref["scores"], self._data(), limits
        )


def embed_gap(tables, samples: list) -> float:
    """``embed_gap``: the largest L2 distance between a row of ``tables``
    (the query table, then the passage table) and the reference's vector
    of it in ``samples`` (``Driver.reference_samples``)."""
    gap = 0.0
    for table, (rows, want) in zip(tables, samples, strict=True):
        got = table[torch.from_numpy(rows).to(table.device)]
        gap = max(gap, float(torch.linalg.vector_norm(got.float() - want, dim=-1).max()))
    return gap
