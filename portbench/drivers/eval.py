"""The epoch eval: ``TowerTrainer.evaluate()`` back to back over one split.

Set-up builds the trainer over the split and calls ``evaluate()`` once,
which builds and uploads its plans; the window calls it until the deadline
has passed. ``eval_impressions_per_s`` is every impression those calls
scored and reduced to the MIND metrics, over their wall time. After the
window the reference scores the split from the same weights, table and
behaviours: the last call's scores are held to the reference's, slot by
slot, and every call's metrics to those the reference works out from the
scores the call reduced.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, generate, port, weights
from portbench.reference import metrics as ref_metrics
from portbench.reference import scoring as ref_scoring
from portbench.reference.common import Precision, float32_matmuls
from portbench.trace import traced
from portbench.work import cosine_flops

METRICS = ("auc", "mrr", "ndcg5", "ndcg10")


class Driver:
    def __init__(self, cell, seed: int, seconds: float, device, trace: bool):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.seed = int(seed) % 2**63
        self.device = torch.device(device)
        self.trace = trace
        self.tower_mod = cell.reference()
        self.calls = {"window": 0, "traced": 0}
        self.phase = "window"
        self.window_s = 0.0
        self.unit_s: list[float] = []
        self.results: list[dict] = []
        self.scores = None

    def _data(self):
        return generate.behaviors(
            generate.seed_rng(self.seed, 1), self.cfg[self.traffic["rows"]], self.cfg["news"], self.traffic["behaviors"]
        )

    def inputs(self) -> None:
        """The news table and the weights, from the seed, on the device."""
        cfg, dev = self.cfg, self.device
        gen = weights.device_generator
        self.table = weights.news_table(cfg["news"], cfg["tower"]["reduced_dim"], gen(self.seed, 2, dev), dev)
        self.init = weights.make_params(self.tower_mod.param_shapes(cfg["tower"]), gen(self.seed, 3, dev), dev)

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        data = self._data()
        self.rows = data.rows
        self.tokens = float(np.minimum(data.hist_lens, cfg["history_cap"]).sum())
        self.slots = float(data.imp_lens.sum())
        self.inputs()
        from news_recommendation_project_v2_torch.train.trainer import TowerTrainer

        self.tower = port.build_tower(cfg, self.init, dev)
        self.trainer = TowerTrainer(
            self.tower, port.compiled(data, cfg["news"]), self.table, cfg=port.train_config(cfg, self.seed),
            flat_train=cfg["flat_train"], flat_eval=cfg["flat_eval"], device_metrics=cfg["flat_eval"], device=dev,
        )
        if self.trace:
            self.tower.register_forward_hook(self._count_call)
        self.trainer.evaluate()
        self._capture_scores()

    def _capture_scores(self) -> None:
        """Keep the cosine scores of each ``evaluate()`` call, on the device,
        as its flat eval plan hands them to the metrics (no copy, no wait);
        the check holds the last call's to the reference."""
        fplan, _ = next(iter(self.trainer._fused_plans.values()))
        scores = fplan._scores

        def kept(*args, **kwargs):
            self.scores = scores(*args, **kwargs)
            return self.scores

        fplan._scores = kept

    def _count_call(self, *_) -> None:
        self.calls[self.phase] += 1

    def window(self, seconds: float) -> tuple[dict, int, int]:
        failed = 0
        t0 = last = time.perf_counter()
        while True:
            scores = self.trainer.evaluate()[0]
            self.results.append(scores)
            failed += not all(np.isfinite(scores[k]) for k in METRICS)
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
        with traced(out):
            self.trainer.evaluate()

    def readings(self) -> dict:
        tower = self.cfg["tower"]
        n = len(self.results)
        flops = n * (
            self.tower_mod.forward_flops(tower, self.tokens, 0.0, max(1, self.calls["window"] // max(n, 1)))
            + cosine_flops(tower["reduced_dim"], self.slots)
        )
        return {
            "kind": "eval",
            "window_s": self.window_s,
            "traced": {"tokens": self.tokens, "calls": self.calls["traced"]},
            "model_flops": flops,
        }

    def release(self) -> None:
        self.trainer = self.tower = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: Precision, rows=None) -> dict:
        """The split's scores, slot by slot, and its metrics (of ``rows`` of
        it, if given)."""
        float32_matmuls()
        cfg, data = self.cfg, self._data()
        if rows is not None:
            data = subset(data, rows)
        users = ref_scoring.user_vectors(
            self.tower_mod, self.init, cfg["tower"], self.table, data.hist_rev, data.hist_lens, cfg["history_cap"], prec
        )
        scores = ref_scoring.slot_scores(users, self.table, data.imp_rev, data.imp_lens)
        return {"scores": scores, "metrics": ref_metrics.mind_metrics(scores, data.labels, data.imp_lens)}

    def check(self) -> list[dict]:
        ref = self.reference(Precision("float32"))
        data = self._data()
        got = self.scores.double().cpu().numpy()
        return numbers(got, self.results, ref["scores"], data, self.cell.limits)


def numbers(scores, results: list, ref_scores, data, limits: dict) -> list[dict]:
    """``score_gap``: the widest gap of a slot's cosine score, as the timed
    path handed it to the metrics, from the reference's. ``metric_gap``: the
    widest gap of any call's metric from the MIND metrics that the reference
    works out from those same scores (the reduction, apart from the
    scores)."""
    if scores is None or not results:
        return [check.entry("score_gap", float("inf"), limits["score_gap"]),
                check.entry("metric_gap", float("inf"), limits["metric_gap"])]
    score_gap = float(np.abs(np.asarray(scores, np.float64) - ref_scores).max())
    own = ref_metrics.mind_metrics(scores, data.labels, data.imp_lens)
    metric_gap = max(abs(r[k] - own[k]) for r in results for k in METRICS)
    return [check.entry("score_gap", score_gap, limits["score_gap"]), check.entry("metric_gap", metric_gap, limits["metric_gap"])]


def subset(data, rows) -> generate.Behaviors:
    """The behaviours of ``rows`` (ascending) alone."""
    rows = np.asarray(rows)

    def take(flat, lens):
        ends = np.cumsum(lens)
        keep = np.concatenate([np.arange(e - n, e) for e, n in zip(ends[rows], lens[rows])])
        return flat[keep]

    return generate.Behaviors(
        data.hist_lens[rows], take(data.hist_rev, data.hist_lens), data.imp_lens[rows],
        take(data.imp_rev, data.imp_lens), take(data.labels, data.imp_lens),
    )
