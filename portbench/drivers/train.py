"""Training: ``TowerTrainer.train_one_epoch()`` back to back.

Set-up builds the trainer once, drives it through a first whole epoch (its
first three steps recorded on the way: each loss, the optimizer's state
after the first, the parameters when the fourth begins) and hands that same
trainer to the window, which runs whole epochs until the deadline has
passed. ``train_pairs_per_s`` is every pair of those epochs over their wall
time. After the window the reference follows the first three steps from
the same weights, table and behaviours.
"""

from __future__ import annotations

import math
import sys
import time
from collections import Counter

import torch

from portbench import check, generate, port, weights
from portbench.reference import train as ref_train
from portbench.reference.common import Precision, float32_matmuls
from portbench.trace import traced

STEPS = 3


class StepProbe:
    """Records the trainer's first ``STEPS`` steps as they run in its own
    epoch: each step's loss, the gradient the optimizer took at the first
    (from its first moment), and the parameters as the next step begins."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.losses: list[torch.Tensor] = []
        self.grad1 = None
        self.params = None
        trainer._train_step = self._step

    def _snapshot(self) -> None:
        self.params = {k: p.detach().clone() for k, p in self.trainer.model.named_parameters()}
        self.trainer.__dict__.pop("_train_step", None)

    def _step(self, batch):
        t = self.trainer
        if len(self.losses) == STEPS:
            self._snapshot()
            return t._train_step(batch)
        loss = type(t)._train_step(t, batch)
        self.losses.append(loss.detach().clone())
        if self.grad1 is None:
            beta1 = t.optimizer.param_groups[0]["betas"][0]
            state = t.optimizer.state
            self.grad1 = {
                k: state[p]["exp_avg"].detach() / (1.0 - beta1) if "exp_avg" in state[p] else torch.zeros_like(p)
                for k, p in t.model.named_parameters()
            }
        return loss

    def finish(self) -> None:
        if len(self.losses) < STEPS:
            raise RuntimeError(f"the first epoch ran {len(self.losses)} steps; the check needs {STEPS}")
        if self.params is None:
            self._snapshot()


class Driver:
    def __init__(self, cell, seed: int, seconds: float, device, trace: bool):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.seed = int(seed) % 2**63
        self.device = torch.device(device)
        self.trace = trace
        self.tower_mod = cell.reference()
        self.counts = {"window": Counter(), "traced": Counter()}
        self.phase = "window"
        self.window_s = 0.0
        self.unit_s: list[float] = []

    # -- the data, the same on both sides --------------------------------

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
        self.pairs_per_epoch = ref_train.pairs_per_epoch(data.imp_lens, data.labels)
        self.inputs()
        from news_recommendation_project_v2_torch.train.trainer import TowerTrainer

        tower = port.build_tower(cfg, self.init, dev)
        self.trainer = TowerTrainer(
            tower, port.compiled(data, cfg["news"]), self.table, cfg=port.train_config(cfg, self.seed),
            flat_train=cfg["flat_train"], flat_eval=cfg["flat_eval"], device=dev,
        )
        if self.trace:
            self._count_batches()
        self.probe = StepProbe(self.trainer)
        self.trainer.train_one_epoch()
        self.probe.finish()
        self.probe_losses = [float(x) for x in self.probe.losses]
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _count_batches(self) -> None:
        """Counts each batch's real tokens, squared row lengths, pairs and
        steps as the trainer's feed hands it over (host tensors)."""
        trainer, flat = self.trainer, self.cfg["flat_train"]
        feed = trainer._host_batches

        def counted():
            for count, batch in feed():
                lens = batch[2] if flat else batch[1].sum(1)
                c = self.counts[self.phase]
                c["tokens"] += float(lens.sum())
                c["sq_tokens"] += float((lens * lens).sum())
                c["pairs"] += count
                c["calls"] += 1
                yield count, batch

        trainer._host_batches = counted

    # -- the window --------------------------------------------------------

    def window(self, seconds: float) -> tuple[dict, int, int]:
        epochs = failed = 0
        t0 = last = time.perf_counter()
        while True:
            loss = self.trainer.train_one_epoch()
            epochs += 1
            failed += not math.isfinite(loss)
            now = time.perf_counter()
            self.unit_s.append(now - last)
            last = now
            if now - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        return {"train_pairs_per_s": self.pairs_per_epoch * epochs / self.window_s}, epochs, failed

    def traced(self, out: list) -> None:
        self.phase = "traced"
        with traced(out):
            self.trainer.train_one_epoch()

    def readings(self) -> dict:
        tower = self.cfg["tower"]

        def flops(c):
            fwd = self.tower_mod.forward_flops(tower, c["tokens"], c["sq_tokens"], int(c["calls"]))
            return 3.0 * (fwd + 2 * c["pairs"] * 4.0 * tower["reduced_dim"])

        w = self.counts["window"]
        return {
            "kind": "train",
            "window_s": self.window_s,
            "traced": dict(self.counts["traced"]),
            "model_flops": flops(w) if w["calls"] else None,
        }

    def release(self) -> None:
        self.trainer = self.probe.trainer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------

    def reference(self, prec: Precision, pair_filter=None) -> dict:
        float32_matmuls()
        gen = torch.Generator(device=self.device).manual_seed(self.seed) if self.cfg["tower"]["dropout_rate"] else None
        return ref_train.follow(
            self.tower_mod, self.init, self.cfg["tower"], self.cfg["train"], self.table, self._data(), self.seed, STEPS,
            prec, self.cfg["history_cap"], tuple(self.cfg["history_buckets"]), gen, pair_filter,
        )

    def check(self) -> list[dict]:
        ref = self.reference(Precision("float32"))
        got = {"losses": self.probe_losses, "grad1": self.probe.grad1, "params": self.probe.params}
        return numbers(got, ref, self.init, self.cell.limits)


def numbers(got: dict, ref: dict, init: dict, limits: dict) -> list[dict]:
    """Each step's loss (the worst relative gap), the first gradient's and
    the three steps' change's norms by the worst leaf; the change over the
    elements that the reference's first gradient moves (``check.moved_elements``)."""
    loss = max(check.rel_gap(a, b) for a, b in zip(got["losses"], ref["losses"]))
    grad, grad_leaf = check.leaf_norm_gap(got["grad1"], ref["grad1"])
    moved = check.moved_elements(ref["grad1"])
    left_out = {k: int((~moved[k]).sum()) if k in moved else init[k].numel() for k in init}
    left_out = {k: n for k, n in left_out.items() if n}
    print(f"update_gap leaves out elements nought to rounding in the reference's gradient: {left_out}", file=sys.stderr)
    d_got = {k: got["params"][k] - init[k] for k in init}
    d_ref = {k: ref["params"][k] - init[k] for k in init}
    update, update_leaf = check.leaf_norm_gap(d_got, d_ref, moved)
    print(f"worst leaves: grad_gap {grad_leaf}, update_gap {update_leaf}", file=sys.stderr)
    return [
        check.entry("loss_gap", loss, limits["loss_gap"]),
        check.entry("grad_gap", grad, limits["grad_gap"]),
        check.entry("update_gap", update, limits["update_gap"]),
    ]
