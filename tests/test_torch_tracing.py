"""The port's spans and counters (``utils.profiling``) in the trainer loop,
its prefetch producer, the flat eval and the corpus encode, on the CPU:
nothing records
without a profiler; under ``torch.profiler`` the spans nest as documented,
the producer's are kept, and each span agrees with its
``record_function`` event; the counters equal the counts of the batches and
chunks that ran; tracing changes no loss, parameter or metric; the
recorder loses nothing across threads."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from eager_graphs import EagerGraphs
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.prefetch import prefetch
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.models.news_encoder import HashTokenizer, NewsEncoder, encoder_config_from_hf
from news_recommendation_project_v2_torch.ops.encode import (
    encode_corpus_bucketed,
    encode_query_and_passage,
    instruction_pool_mask,
)
from news_recommendation_project_v2_torch.train.trainer import TowerTrainer
from news_recommendation_project_v2_torch.utils import profiling
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = 32
TOWER = dict(kind="latent", reduced_dim=D, num_latents=8, latent_dim_head=16)
ROUTES = {"flat": dict(flat_train=True, flat_eval=True, device_metrics=True),
          "padded": dict(flat_train=False, flat_eval=False)}
TRAIN_LOOP = {"train.wait_batch", "train.step", "train.loss_fetch"}
MS = 1_000_000


@pytest.fixture(autouse=True)
def _cleared():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def data():
    imps, hist, emb = synthetic_learnable_behaviors(num_news=120, num_rows=240, dim=D, noise=0.05, seed=3)
    ct = compile_behaviors(imps, hist).with_history_view()
    return ct, align_embeddings(ct.news_ids, emb)


def _trainer(data, route="flat", **cfg):
    ct, emb = data
    torch.manual_seed(0)
    tower = build_tower(TowerConfig(**TOWER))
    cfg = TrainConfig(**{"learning_rate": 3e-4, "batch_size": 64, "seed": 0, **cfg})
    return TowerTrainer(tower, ct, emb, cfg=cfg, device="cpu", **ROUTES[route])


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events() if "CPU" in str(e.device_type())]
    return out, events


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def _agree_with_events(spans, events, names):
    """Each span of ``names`` and its ``record_function`` event, in order of
    start, within a millisecond at both ends."""
    for name in names:
        mine = sorted(_by_name(spans, name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in events if e.name() == name), key=lambda e: e.start_ns())
        assert len(mine) == len(theirs) > 0, name
        for s, e in zip(mine, theirs):
            assert abs(s.start_ns - e.start_ns()) < MS, name
            assert abs(s.end_ns - (e.start_ns() + e.duration_ns())) < MS, name


def test_nothing_records_without_a_profiler(data):
    trainer = _trainer(data)
    trainer.train_one_epoch()
    trainer.evaluate()
    assert profiling.recorded() == ([], {})
    assert profiling.span("train.step") is profiling.span("eval.chunk")  # the shared no-op
    profiling.count("train.steps")
    assert profiling.recorded().counters == {}


@pytest.mark.parametrize("route", list(ROUTES))
def test_train_spans_nest_and_agree_with_the_profiler(data, route):
    trainer = _trainer(data, route)
    _, events = _profiled(trainer.train_one_epoch)
    spans, counters = profiling.recorded()
    (epoch,) = _by_name(spans, "train.epoch")
    assert epoch.parent is None and epoch.thread == "MainThread"
    steps = counters["train.steps"]
    assert len(_by_name(spans, "train.step")) == steps > 1
    assert len(_by_name(spans, "train.wait_batch")) == steps + 1  # the last wait takes the end
    assert len(_by_name(spans, "train.loss_fetch")) == steps + 1  # every step's and the epoch's end
    for s in spans:
        if s.name in TRAIN_LOOP:
            assert s.parent == "train.epoch" and s.thread == "MainThread", s
            assert epoch.start_ns <= s.start_ns <= s.end_ns <= epoch.end_ns, s
    builds = _by_name(spans, "train.build_batch")
    assert len(builds) == steps + 1  # the last finds the epoch's end
    assert all(b.thread == "prefetch" and b.parent is None for b in builds)
    assert all(epoch.start_ns <= b.start_ns <= b.end_ns <= epoch.end_ns for b in builds)
    assert not [e for e in events if e.name() == "train.build_batch"]  # the profiler keeps no producer thread
    _agree_with_events(spans, events, ["train.epoch", *TRAIN_LOOP])


def test_eval_spans_nest_and_agree_with_the_profiler(data):
    trainer = _trainer(data)
    trainer.evaluate()  # builds the plans outside the profiler
    profiling.clear()
    _, events = _profiled(trainer.evaluate)
    spans, _ = profiling.recorded()
    (call,) = _by_name(spans, "eval.evaluate")
    assert call.parent is None
    fplan, _ = next(iter(trainer._fused_plans.values()))
    assert len(_by_name(spans, "eval.chunk")) == len(fplan.history.chunks)
    assert len(_by_name(spans, "eval.fetch")) == 1
    for s in spans:
        if s.name != "eval.evaluate":
            assert s.parent == "eval.evaluate" and call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns, s
    _agree_with_events(spans, events, ["eval.evaluate", "eval.chunk", "eval.fetch"])


@pytest.mark.parametrize("route", list(ROUTES))
def test_train_counters_equal_the_batches_that_ran(data, route):
    trainer = _trainer(data, route)
    seen = []
    feed = trainer._host_batches

    def kept():
        for count, batch in feed():
            seen.append((count, [t.numpy().copy() for t in batch]))
            yield count, batch

    trainer._host_batches = kept
    _profiled(trainer.train_one_epoch)
    B = trainer.cfg.batch_size
    if route == "flat":  # tok_idx, tok_rows (pad row B), ...
        real = sum(int((b[1] < B).sum()) for _, b in seen)
        computed = sum(len(b[0]) for _, b in seen)
        rows = {}
    else:  # hist_idx, hist_mask [U, L] (the batch's deduped rows), ...
        real = sum(int((b[1] > 0).sum()) for _, b in seen)
        computed = sum(b[1].size for _, b in seen)
        rows = {"train.rows_computed": sum(b[1].shape[0] for _, b in seen)}
        assert all(b[1].shape[0] == int(b[2].max()) + 1 < B for _, b in seen)
    assert profiling.recorded().counters == {
        "train.steps": len(seen),
        "train.pairs": int(sum(int(b[-1].sum()) for _, b in seen)),
        "train.tokens_real": real,
        "train.tokens_computed": computed,
        **rows,
    }
    assert computed > real > 0


def test_eval_counters_equal_the_chunks_that_ran(data):
    trainer = _trainer(data)
    _profiled(trainer.evaluate)
    _profiled(trainer.evaluate)
    fplan, _ = next(iter(trainer._fused_plans.values()))
    chunk = len(fplan.history.chunks[0][0])
    real = int(np.minimum(trainer.ct.hist_lens, trainer.buckets[-1]).sum())
    assert profiling.recorded().counters == {
        "eval.tokens_real": 2 * real,
        "eval.tokens_computed": 2 * -(-real // chunk) * chunk,
    }


@pytest.mark.parametrize("route", list(ROUTES))
def test_tracing_changes_no_loss_parameter_or_metric(data, route):
    runs = []
    for traced in (False, True):
        trainer = _trainer(data, route)
        if traced:
            (loss, scores), _ = _profiled(lambda: (trainer.train_one_epoch(), trainer.evaluate()))
        else:
            loss, scores = trainer.train_one_epoch(), trainer.evaluate()
        runs.append((loss, scores, [p.detach().clone() for p in trainer.model.parameters()]))
    (loss0, scores0, params0), (loss1, scores1, params1) = runs
    assert loss0 == loss1 and scores0 == scores1
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))
    assert profiling.recorded().counters["train.steps"] > 0


GRAPH_COUNTERS = ("train.graph_captures", "train.graph_replays")


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_cpu_route_counts_no_graph(data, route):
    """The CPU trainer steps eagerly: under the profiler neither graph
    counter appears, while its steps count."""
    trainer = _trainer(data, route)
    _profiled(trainer.train_one_epoch)
    counters = profiling.recorded().counters
    assert counters["train.steps"] > 1
    assert not set(GRAPH_COUNTERS) & set(counters)


def test_graph_counters_count_captures_and_replays(data):
    """Through ``tests/eager_graphs.py``'s stand-in for the card's graphs,
    two traced epochs count one capture a signature and one replay for each
    step a graph served (the captured step's own included): the steps that
    ran eagerly, one warm-up a signature, are ``train.steps`` less the
    replays."""
    trainer = _trainer(data)
    trainer._graphs = EagerGraphs(trainer.optimizer, trainer.device)
    _profiled(lambda: [trainer.train_one_epoch() for _ in range(2)])
    counters = profiling.recorded().counters
    kinds = trainer._graphs.kinds()
    signatures = {sig for _, sig in trainer._graphs.log}
    assert counters["train.graph_captures"] == kinds.count("capture") == len(signatures)
    assert counters["train.graph_replays"] == kinds.count("replay") > len(signatures)
    assert counters["train.steps"] - counters["train.graph_replays"] == kinds.count("warm") == len(signatures)


def test_prefetch_records_both_sides_only_where_its_consumer_records():
    assert list(prefetch(range(5), spans=("wait", "build"))) == list(range(5))
    assert profiling.recorded() == ([], {})
    with profiling.recording(True):
        assert list(prefetch(range(5), spans=("wait", "build"))) == list(range(5))
        assert list(prefetch(range(3))) == list(range(3))  # no names: no spans
    spans = profiling.recorded().spans
    assert [s.thread for s in _by_name(spans, "build")] == ["prefetch"] * 6
    assert [s.thread for s in _by_name(spans, "wait")] == ["MainThread"] * 6
    assert {s.name for s in spans} == {"wait", "build"}


def test_profile_trace_writes_the_spans_beside_the_trace(data, tmp_path):
    with profiling.recording(True), profiling.span("stale"):
        pass
    trainer = _trainer(data)
    with profiling.profile_trace(tmp_path):
        trainer.train_one_epoch()
    assert (tmp_path / "trace.json").is_file()
    written = json.loads((tmp_path / "spans.json").read_text())
    names = {s["name"] for s in written["spans"]}
    assert "stale" not in names and {"train.epoch", "train.build_batch", *TRAIN_LOOP} <= names
    assert {s["thread"] for s in written["spans"] if s["name"] == "train.build_batch"} == {"prefetch"}
    assert written["counters"]["train.steps"] == len([s for s in written["spans"] if s["name"] == "train.step"])


def test_counters_and_spans_lose_nothing_across_threads():
    """Sixteen recording threads at a shortened switch interval, each adding
    to one shared counter and closing spans: no update is lost."""
    threads, n = 16, 400

    def work():
        with profiling.recording(True):
            for _ in range(n):
                profiling.count("shared")
                with profiling.span("s"):
                    pass

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(before)
    spans, counters = profiling.recorded()
    assert counters == {"shared": threads * n}
    assert len(spans) == threads * n and {s.parent for s in spans} == {None}


NV_EMBED = {
    "architectures": ["NVEmbedModel"],
    "text_config": {"architectures": ["MistralModel"], "vocab_size": 97, "hidden_size": 32, "intermediate_size": 64,
                    "num_hidden_layers": 1, "num_attention_heads": 4, "num_key_value_heads": 2,
                    "max_position_embeddings": 64, "sliding_window": 4096},
    "latent_attention_config": {"num_latents_value": 4, "num_cross_heads": 2, "cross_dim_head": 8, "latent_dim": 32},
}


def test_encode_is_one_unit_and_counts_what_it_computed():
    """``encode_query_and_passage`` is one ``encode.corpus`` unit (its inner
    bucketed encodes open none of their own); ``encode.batch`` spans one a
    batch; the counters are the rows, the real tokens, rows x width of every
    batch computed, and the tokens the pool took (the query rows' without
    the instruction). A bucketed encode alone is a unit of its own, and
    nothing records without a profiler."""
    torch.manual_seed(0)
    enc = NewsEncoder(encoder_config_from_hf(NV_EMBED, compute_dtype="float32", max_length=24)).eval()
    tok = HashTokenizer(vocab_size=97, max_length=24)
    rng = np.random.default_rng(0)
    texts = [" ".join(f"w{w}" for w in rng.integers(0, 50, size=int(c))) for c in rng.integers(1, 14, size=13)]
    instruction = "find news like this one: "
    buckets, batch = (8, 16), 4
    encode_query_and_passage(enc, tok, texts, instruction, batch_size=batch, buckets=buckets, device="cpu")
    assert profiling.recorded() == ([], {})
    _, events = _profiled(lambda: encode_query_and_passage(
        enc, tok, texts, instruction, batch_size=batch, buckets=buckets, device="cpu"))
    spans, counters = profiling.recorded()
    units = [s for s in spans if s.name == "encode.corpus"]
    assert len(units) == 1 and units[0].parent is None
    (p_ids, p_mask), (q_ids, q_mask) = tok(texts), tok([instruction + t for t in texts])
    computed = batches = 0
    for mask in (p_mask, q_mask):
        lens = mask.sum(1)
        for lo, w in zip((0, *buckets), (*buckets, 24)):
            n = int(((lens > lo) & (lens <= w)).sum())
            if n:
                bs = max(8, min(batch, 1 << (n - 1).bit_length()))
                batches += -(-n // bs)
                computed += -(-n // bs) * bs * w
    assert [s.parent for s in spans if s.name == "encode.batch"] == ["encode.corpus"] * batches
    pool = instruction_pool_mask(tok, instruction, q_ids, q_mask)
    assert counters == {
        "encode.rows": 2 * len(texts),
        "encode.tokens_real": int(p_mask.sum() + q_mask.sum()),
        "encode.tokens_computed": computed,
        "encode.pool_tokens": int(p_mask.sum() + pool.sum()),
    }
    assert sum(e.name() == "encode.batch" for e in events) == batches
    profiling.clear()
    _profiled(lambda: encode_corpus_bucketed(enc, p_ids, p_mask, buckets, batch, "cpu"))
    assert [s.name for s in profiling.recorded().spans if s.name == "encode.corpus"] == ["encode.corpus"]
