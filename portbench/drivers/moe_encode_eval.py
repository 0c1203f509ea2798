"""Encode, then rank, with a sparse LLM embedder: ``encode_eval``'s unit
(``drivers/encode_eval.py``, whose code this driver takes by import) with a
DeepSeek-V3-layout encoder, Moonlight-16B-A3B.

A unit encodes the configuration's ``news`` titles into both tables with
``ops.encode.encode_query_and_passage`` (query rows BOS, the instruction,
the title and EOS; passage rows BOS, the title and EOS; every row pooled at
its last real token), then ranks the ``dev_rows`` impressions over them with
the user tower's flat eval. The configuration file is the encoder's
``config.json`` (its keys at the top level) with the cell's own keys beside
them; BOS and EOS are its ``bos_token_id`` and ``eos_token_id``, title ids
uniform below BOS. Set-up builds the encoder's configuration first, so a
program without the layout stops there, before any weight is drawn.

After the window the reference checks the last timed unit:

- ``embed_gap``: the largest L2 distance between the program's unit vectors
  and the plain float32 Moonlight's (``reference/moonlight.py``, on the
  program's own bfloat16 weights) over a seeded sample of rows of each
  table (every bucket present);
- ``route_mismatch``: over the sampled rows' real tokens and every MoE
  layer, the share whose set of experts (as the program's router picked
  them in that unit, read by hooks on its routers) differs from the
  reference's own float32 routing.

The reference applies the program's picks in each MoE layer, weighted by
its own float32 scores of them, and records its own picks beside them:
with random weights a token whose 6th and 7th experts lie within the
program's rounding of each other flips, and a flipped expert moves the
token as far as a layer does, so two free forward passes part within a
dozen layers (measured: ``embed_gap`` 0.91-0.96, ``route_mismatch`` 57-63%,
PERF.md). Held to the program's picks, the reference checks every
continuous part at its precision, ``embed_gap``, and the discrete choice on
its own, ``route_mismatch``.
- ``score_gap`` and ``metric_gap`` against the reference tower over the
  program's own tables, as the eval cells check.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, generate, port, weights
from portbench.drivers import encode_eval
from portbench.drivers.encode_eval import REF_BLOCK, embed_gap
from portbench.reference import moonlight
from portbench.reference.common import Precision, float32_matmuls

eval_driver = encode_eval.eval_driver
# Set-up runs whole units for at least this long before the window, so the
# card starts the window at the temperature it runs at: under its 700 W cap
# a unit of this cell slows by ~2% from a cold card to a warm one (clocks
# 1,980 -> ~1,700-1,900 MHz as it heats from ~42 to ~62 C; PERF.md).
WARM_S = 20.0


class IdTokenizer(encode_eval.IdTokenizer):
    """``encode_eval``'s tokenizer with the encoder's own BOS and EOS."""

    def __init__(self, width: int, bos: int, eos: int):
        super().__init__(width)
        self.bos, self.eos = bos, eos

    def __call__(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        ids, mask = super().__call__(texts)
        ids[:, 0] = self.bos
        ids[np.arange(len(ids)), mask.sum(1) - 1] = self.eos
        return ids, mask


class RouteRecorder:
    """The program's routing in one unit: for each call of the encoder its
    ids and mask (the batch on the device, as handed in), and for each of
    its MoE layers the router's picks [real tokens, k], read by forward
    hooks. ``start(True)`` begins a unit's record (the last one is kept),
    ``start(False)`` records nothing."""

    def __init__(self, encoder):
        from news_recommendation_project_v2_torch.models.moe import MoEGate

        self.on, self.calls = False, []
        encoder.register_forward_pre_hook(self._call)
        for m in encoder.modules():
            if isinstance(m, MoEGate):
                m.register_forward_hook(self._picked)

    def start(self, on: bool) -> None:
        self.on = on
        if on:
            self.calls = []

    def _call(self, module, args):
        if self.on:
            self.calls.append((args[0], args[1], []))

    def _picked(self, module, args, out):
        if self.on:
            self.calls[-1][2].append(out[0])

    def picks(self, tables) -> list[torch.Tensor]:
        """Per MoE layer, the picks [n, k] (each row's experts sorted) of the
        real tokens of ``tables`` (``(ids, mask, rows)``: the sampled rows,
        ascending, of each table in turn), row by row, position by
        position. A row is found among the calls by its ids."""
        index, starts = {}, []
        for c, (ids, mask, _) in enumerate(self.calls):
            ids, lens = ids.cpu().numpy(), mask.cpu().numpy().sum(1)
            starts.append(np.concatenate([[0], np.cumsum(lens)[:-1]]))
            for j in range(len(ids)):
                index[ids[j, : lens[j]].tobytes()] = (c, j)
        where: dict[int, tuple[list, list]] = {}
        n = 0
        for ids, mask, rows in tables:
            for r in rows:
                length = int(mask[r].sum())
                c, j = index[ids[r, :length].tobytes()]
                pos, dest = where.setdefault(c, ([], []))
                pos.append(starts[c][j] + np.arange(length))
                dest.append(n + np.arange(length))
                n += length
        layers = len(self.calls[0][2])
        out = []
        for layer in range(layers):
            k = self.calls[0][2][layer].shape[1]
            got = torch.empty(n, k, dtype=torch.long, device=self.calls[0][2][layer].device)
            for c, (pos, dest) in where.items():
                src = self.calls[c][2][layer]
                got[torch.from_numpy(np.concatenate(dest)).to(src.device)] = src[
                    torch.from_numpy(np.concatenate(pos)).to(src.device)
                ]
            out.append(got.sort(dim=-1).values)
        return out


def route_mismatch(got: list, want: list) -> float:
    """The share of (token, MoE layer) whose set of experts differs; a
    layer missing from either side, or picks of another count, differ
    whole."""
    if not got or not want:
        return 1.0
    total = sum(w.shape[0] for w in want) * max(len(got), len(want)) / len(want)
    same = 0.0
    for g, w in zip(got, want):
        if g.shape == w.shape:
            same += float((g == w).all(-1).sum())
    return 1.0 - same / total


class Driver(encode_eval.Driver):
    def __init__(self, cell, seed: int, seconds: float, device, trace: bool):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.hf = self.cfg  # the encoder's config.json keys lie at the top level
        self.seed = int(seed) % 2**63
        self.device = torch.device(device)
        self.trace = trace
        self.tower_mod = cell.reference()
        self.tokenize = IdTokenizer(self.cfg["token_width"], self.hf["bos_token_id"], self.hf["eos_token_id"])
        self.phase = "setup"
        self.window_s = self.traced_s = 0.0
        self.unit_s: list[float] = []
        self.results: list[dict] = []
        self.last = None
        self.scores = None
        self.routes = None

    def texts(self) -> tuple[list[str], str]:
        """The unit's titles and the instruction, as decimal ids below BOS."""
        t = self.traffic["titles"]
        n, top = self.cfg["news"], self.hf["bos_token_id"]
        sizes = generate.seed_rng(0, 98)
        lens = np.minimum(t["min_tokens"] + sizes.poisson(t["mean_extra"], size=n), t["max_tokens"])
        rng = generate.seed_rng(self.seed, 4)
        lens = lens[rng.permutation(n)]
        ids = rng.integers(3, top, size=int(lens.sum()))
        instruction = rng.integers(3, top, size=self.traffic["instruction_tokens"])
        ends = np.cumsum(lens)
        titles = [" ".join(map(str, ids[e - k : e])) for k, e in zip(lens, ends)]
        return titles, " ".join(map(str, instruction)) + " "

    def encoder_params(self) -> dict[str, torch.Tensor]:
        """The encoder's weights on the device in its parameter type, drawn
        from the seed one parameter at a time (``moonlight.draw``)."""
        dt = getattr(torch, self.cfg["encoder_dtype"]["param_dtype"])
        return moonlight.draw(self.hf, weights.device_generator(self.seed, 5, self.device), self.device, dt)

    def setup(self) -> None:
        from news_recommendation_project_v2_torch.models.news_encoder import encoder_config_from_hf

        cfg, dev = self.cfg, self.device
        encoder_config_from_hf(self.hf)  # the layout first: without it the run stops here
        data = self._data()
        self.rows = data.rows
        self.tokens = float(np.minimum(data.hist_lens, cfg["history_cap"]).sum())
        self.titles, self.instruction = self.texts()
        self.inputs()
        from news_recommendation_project_v2_torch.ops.encode import TOKEN_BUCKETS
        from news_recommendation_project_v2_torch.train.trainer import TowerTrainer

        self.buckets = TOKEN_BUCKETS
        self.encoder = self._encoder()
        self.routes = RouteRecorder(self.encoder)
        self.tower = port.build_tower(cfg, self.init, dev)
        query, passage = self._encode()
        self.trainer = TowerTrainer(
            self.tower, port.compiled(data, cfg["news"]), passage, query_news_emb_train=query,
            cfg=port.train_config(cfg, self.seed), flat_train=cfg["flat_train"], flat_eval=cfg["flat_eval"],
            device_metrics=True, device=dev,
        )
        self.trainer.evaluate()  # the eval's plans built, the first unit whole
        self._capture_scores()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WARM_S and self.device.type == "cuda":
            self._unit()

    def _unit(self) -> dict:
        self.routes.start(self.phase != "traced")
        return super()._unit()

    def readings(self) -> dict:
        _, q_mask, _, _, p_mask = self.tables_tokens()
        lens = np.concatenate([q_mask.sum(1), p_mask.sum(1)])
        return {
            "kind": "moe_encode_eval",
            "window_s": self.window_s,
            "traced": {
                "unit_s": self.traced_s,
                "tokens": self.tokens,
                "encode_tokens": float(lens.sum()),
                "encode_flops": moonlight.forward_flops(self.hf, lens),
            },
        }

    # -- the reference ----------------------------------------------------------

    def sampled_tables(self) -> list:
        """``(ids, mask, rows)`` of the query table, then the passage table:
        each table's token rows and its sampled rows."""
        q_ids, q_mask, _, p_ids, p_mask = self.tables_tokens()
        return [(ids, mask, self.sample(mask, stream)) for ids, mask, stream in ((q_ids, q_mask, 6), (p_ids, p_mask, 7))]

    def reference_samples(self, routes: list | None = None, forced: list | None = None, **control) -> list:
        """Each table's sampled rows and the reference's unit vectors of them:
        ``(rows, [rows, D])`` for the query table, then the passage table,
        the rows in blocks of ``REF_BLOCK`` cut to their longest, all blocks
        through each layer in turn. ``routes`` gets the reference's own
        picks, ``forced`` the picks it applies (``moonlight.encode_blocks``);
        ``control`` alters the reference (the controls')."""
        float32_matmuls()
        blocks, cuts, rows_of = [], [], []
        for ids, mask, rows in self.sampled_tables():
            rows_of.append(rows)
            for s in range(0, len(rows), REF_BLOCK):
                r = rows[s : s + REF_BLOCK]
                w = int(mask[r].sum(1).max())
                blocks.append(tuple(torch.from_numpy(np.ascontiguousarray(a[r, :w])).to(self.device) for a in (ids, mask)))
            cuts.append(len(blocks))
        vecs = moonlight.encode_blocks(self.params, self.hf, blocks, routes=routes, forced=forced, **control)
        return [(rows_of[0], torch.cat(vecs[: cuts[0]])), (rows_of[1], torch.cat(vecs[cuts[0] :]))]

    def check(self) -> list[dict]:
        limits = self.cell.limits
        if self.last is None:
            return [
                check.entry("embed_gap", float("inf"), limits["embed_gap"]),
                check.entry("route_mismatch", float("inf"), limits["route_mismatch"]),
            ] + eval_driver.numbers(None, [], None, None, limits)
        last = self.last
        got_routes = self.routes.picks(self.sampled_tables())
        self.routes.calls = []
        want_routes: list = []
        samples = self.reference_samples(routes=want_routes, forced=got_routes)
        gap = embed_gap((last.query, last.passage), samples)
        mismatch = route_mismatch(got_routes, want_routes)
        ref = self.rank_reference(last.query, last.passage, Precision("float32"))
        got = last.scores.double().cpu().numpy()
        return [
            check.entry("embed_gap", gap, limits["embed_gap"]),
            check.entry("route_mismatch", mismatch, limits["route_mismatch"]),
        ] + eval_driver.numbers(got, [last.metrics], ref["scores"], self._data(), limits)
