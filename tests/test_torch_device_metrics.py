"""The port's MIND metrics on the device (``eval.device_metrics``), on the host
(``eval.metrics``), its score composition (``eval.ranker``) and its behaviors
compiler (``data.compiler``) against the JAX package's, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.data.compiler import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.eval import device_metrics as jax_dm
from news_recommendation_project_v2_tpu.eval import metrics as jax_metrics
from news_recommendation_project_v2_tpu.eval import ranker as jax_ranker
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.grouping import dense_rank_by_segment, group_items
from news_recommendation_project_v2_torch.eval import device_metrics as dm
from news_recommendation_project_v2_torch.eval import metrics
from news_recommendation_project_v2_torch.eval.ranker import compose_final_scores, history_candidate_slots
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

KEYS = ("auc", "mrr", "ndcg5", "ndcg10")


def _padded_rows(rng, n=64, max_len=37, quantize=None):
    """Random padded (scores, labels, lens), every row two-class."""
    lens = rng.integers(2, max_len + 1, size=n)
    L = int(lens.max())
    scores = np.full((n, L), -np.inf)
    labels = np.zeros((n, L))
    for i, ln in enumerate(lens):
        s = rng.standard_normal(ln)
        if quantize:
            s = np.round(s, quantize)  # forces score ties
        scores[i, :ln] = s
        y = rng.integers(0, 2, size=ln)
        y[0], y[-1] = 1, 0
        labels[i, :ln] = y
    return scores, labels, lens.astype(np.int64)


@pytest.mark.parametrize("quantize", [None, 1], ids=["distinct", "ties"])
def test_row_metrics_match_jax_and_host(rng, quantize):
    """Per-row metrics against the JAX package's ``row_metrics`` and the
    port's host ``score_batch``, with -inf padding and, rounded to one
    decimal, many tied scores."""
    scores, labels, lens = _padded_rows(rng, quantize=quantize)
    got = [
        t.numpy()
        for t in dm.row_metrics(
            torch.tensor(scores, dtype=torch.float32),
            torch.tensor(labels, dtype=torch.float32),
            torch.tensor(lens, dtype=torch.float32),
        )
    ]
    want = [
        np.asarray(x)
        for x in jax_dm.row_metrics(
            jnp.asarray(scores, jnp.float32), jnp.asarray(labels, jnp.float32), jnp.asarray(lens, jnp.float32)
        )
    ]
    host = metrics.score_batch(scores, labels, lens)
    assert not got[4].any() and not want[4].any()
    for g, w, h in zip(got[:4], want[:4], host):
        np.testing.assert_allclose(g, w, atol=1e-5)
        np.testing.assert_allclose(g, h, atol=1e-5)


def test_tie_order_is_larger_index_first():
    """Ties rank the later candidate first, as the host's reversed stable
    sort does; AUC counts a tie as half."""
    scores = torch.tensor([[0.5, 0.5, 0.1, -torch.inf], [0.5, 0.5, 0.1, -torch.inf]])
    labels = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]])
    auc, mrr, _, _, bad = dm.row_metrics(scores, labels, torch.tensor([3.0, 3.0]))
    assert not bad.any()
    torch.testing.assert_close(auc, torch.tensor([0.75, 0.75]))
    torch.testing.assert_close(mrr, torch.tensor([0.5, 1.0]))


def test_signed_zeros_tie_as_in_jax():
    """-0.0 and 0.0 are one tie group in both packages (lax.sort puts zeros
    of either sign in one place), so the index breaks the tie."""
    scores = np.array([[0.0, -0.0, 0.0, -0.0, 0.5], [-0.0, 0.0, -1.0, 0.0, -0.0]], np.float32)
    labels = np.array([[1, 0, 0, 1, 0], [0, 1, 1, 0, 0]], np.float32)
    lens = np.array([5.0, 5.0], np.float32)
    got = dm.row_metrics(torch.from_numpy(scores), torch.from_numpy(labels), torch.from_numpy(lens))
    want = jax_dm.row_metrics(jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_row_metrics_flag_single_class_rows():
    scores = torch.tensor([[0.3, 0.2], [0.1, 0.4], [-torch.inf, -torch.inf]])
    labels = torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 0.0]])
    *_, bad = dm.row_metrics(scores, labels, torch.tensor([2.0, 2.0, 0.0]))
    assert bad.tolist() == [True, False, False]


def _make_behaviors(rng, rows=40, n_news=30):
    """MIND behavior strings, a quarter of the rows without history."""
    impressions, history = [], []
    for i in range(rows):
        k = int(rng.integers(2, 9))
        ids = rng.choice(n_news, size=k, replace=False)
        labs = rng.integers(0, 2, size=k)
        labs[0] = 1
        if labs.sum() == k:
            labs[-1] = 0
        impressions.append(" ".join(f"N{j}-{y}" for j, y in zip(ids, labs)))
        if i % 4 != 3:
            hk = int(rng.integers(1, 15))
            history.append(" ".join(f"N{j}" for j in rng.choice(n_news, size=min(hk, n_news), replace=False)))
        else:
            history.append(None)
    return impressions, history


FIELDS = (
    "news_ids", "imp_rev", "imp_row", "imp_lens", "hist_rev",
    "hist_row", "hist_lens", "hist_row_index", "labels_flat",
)


@pytest.mark.parametrize("labeled", [True, False])
@pytest.mark.parametrize("view", [False, True], ids=["all_rows", "with_history_view"])
def test_compile_behaviors_equals_jax(rng, labeled, view):
    """The numpy compiler gives the JAX package's pandas path's arrays, to
    the element and the type; and the same with-history view."""
    impressions, history = _make_behaviors(rng)
    history[5], history[6] = "", float("nan")  # other spellings of "no history"
    if not labeled:
        impressions = [" ".join(t.rpartition("-")[0] for t in row.split()) for row in impressions]
    got, want = compile_behaviors(impressions, history), jax_compile(impressions, history, use_native=False)
    if view:
        got, want = got.with_history_view(), want.with_history_view()
    assert got.label_present == want.label_present == labeled
    assert (got.num_rows, got.num_news) == (want.num_rows, want.num_news)
    np.testing.assert_array_equal(got.has_history, want.has_history)
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_compile_behaviors_rejects_a_malformed_label():
    with pytest.raises(ValueError, match="malformed labeled token in row 1"):
        compile_behaviors(["N1-0 N2-1", "N3-1 N4-x"], ["N5", None])


COMPOSE_CASES = ["overwrite", "baseline_alpha", "baseline_only"]


def _compose_case(case, c, hist, base, slots):
    """(host kwargs, device-plan kwargs) of one composition."""
    if case == "overwrite":
        return dict(history_scores=hist), dict(hist_slots=slots)
    if case == "baseline_alpha":
        return (
            dict(history_scores=hist, baseline_scores=base, alpha=0.3),
            dict(hist_slots=slots, baseline_slots=base[c.imp_rev], alpha=0.3),
        )
    return dict(baseline_scores=base), dict(baseline_slots=base[c.imp_rev])


@pytest.mark.parametrize("case", COMPOSE_CASES)
def test_compose_final_scores_and_plan_match_jax(rng, case):
    """The host composition's metrics against the JAX package's, and the
    device plan's (row chunks of 8) against both."""
    impressions, history = _make_behaviors(rng)
    c, jc = compile_behaviors(impressions, history), jax_compile(impressions, history, use_native=False)
    slots, cand_rows = history_candidate_slots(c)
    jslots, jrows = jax_ranker.history_candidate_slots(jc)
    np.testing.assert_array_equal(slots, jslots)
    np.testing.assert_array_equal(cand_rows, jrows)
    hist = rng.random(len(slots)).astype(np.float32)
    base = rng.random(c.num_news).astype(np.float32)
    host_kwargs, plan_kwargs = _compose_case(case, c, hist, base, slots)
    got = compose_final_scores(c, **host_kwargs)
    want = jax_ranker.compose_final_scores(jc, **host_kwargs)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.metrics == pytest.approx(want.metrics, abs=1e-12)
    plan = dm.DeviceMetricsPlan(c.imp_lens, c.labels_flat, row_chunk=8, device="cpu", **plan_kwargs)
    full = plan.compose(torch.from_numpy(hist) if "hist_slots" in plan_kwargs else None)
    on_device = plan.compute(full)
    assert on_device["num_samples"] == want.metrics["num_samples"]
    for k in KEYS:
        np.testing.assert_allclose(on_device[k], want.metrics[k], atol=2e-5, err_msg=k)


@pytest.mark.parametrize("alpha", [None, 0.25], ids=["overwrite", "blend"])
def test_compose_scores_matches_jax(rng, alpha):
    base = rng.random(50).astype(np.float32)
    slots = rng.choice(50, size=20, replace=False)
    hist = rng.random(20).astype(np.float32)
    base_t = torch.from_numpy(base)
    got = dm.compose_scores(base_t, torch.from_numpy(slots), torch.from_numpy(hist), alpha=alpha)
    want = jax_dm.compose_scores(jnp.asarray(base), jnp.asarray(slots), jnp.asarray(hist), alpha=alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(base_t.numpy(), base)  # out of place


def test_plan_over_several_buckets_matches_jax(rng):
    """Impressions of 2 to 300 candidates fall into every length bucket
    (8, 16, ..., the exact maximum); rows chunk by 8, with padded rows."""
    edges = [2, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 256, 257, 300]
    imp_lens = np.concatenate([rng.integers(2, 9, 13), rng.integers(9, 65, 11), edges])
    labels = (rng.random(int(imp_lens.sum())) < 0.3).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(imp_lens)])
    labels[offsets[:-1]], labels[offsets[1:] - 1] = 1.0, 0.0
    scores = np.round(rng.standard_normal(len(labels)), 1).astype(np.float32)
    plan = dm.DeviceMetricsPlan(imp_lens, labels, row_chunk=8, device="cpu")
    assert [g.idx.shape[-1] for g in plan.grids] == [8, 16, 32, 64, 128, 256, 300]
    assert plan.grids[0].idx.shape[:2] == (2, 8)  # 15 rows in chunks of 8
    assert dm._metric_buckets(300) == jax_dm._metric_buckets(300)
    got = plan.compute(scores)
    want = jax_dm.DeviceMetricsPlan(imp_lens, labels, row_chunk=8).compute(scores)
    ranks = group_items(dense_rank_by_segment(scores.astype(np.float64), imp_lens), imp_lens)
    host = metrics.score([r.tolist() for r in ranks], [y.tolist() for y in group_items(labels, imp_lens)])
    assert got["num_samples"] == want["num_samples"] == host["num_samples"] == len(imp_lens)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)
        np.testing.assert_allclose(got[k], host[k], atol=2e-5, err_msg=k)


def test_single_class_row_raises_at_build():
    imp_lens = np.array([3, 2])
    labels = np.array([1, 0, 0, 1, 1], np.float32)
    with pytest.raises(ValueError, match="1 impression"):
        dm.DeviceMetricsPlan(imp_lens, labels, row_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="1 impression"):
        dm.metrics_from_flat_scores(np.zeros(5, np.float32), imp_lens, labels, device="cpu")


def test_metrics_from_flat_scores_matches_host_and_jax(rng):
    impressions, history = _make_behaviors(rng)
    c = compile_behaviors(impressions, history)
    flat = rng.random(int(c.imp_lens.sum()))
    ranks = group_items(dense_rank_by_segment(flat, c.imp_lens), c.imp_lens)
    host = metrics.score([r.tolist() for r in ranks], [y.tolist() for y in group_items(c.labels_flat, c.imp_lens)])
    got = dm.metrics_from_flat_scores(flat.astype(np.float32), c.imp_lens, c.labels_flat, device="cpu")
    want = jax_dm.metrics_from_flat_scores(flat.astype(np.float32), c.imp_lens, c.labels_flat)
    for k in (*KEYS, "num_samples"):
        np.testing.assert_allclose(got[k], host[k], atol=2e-5, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)


def test_host_score_matches_jax(rng, tmp_path):
    """The port's host suite is the JAX package's, debug dump included."""
    impressions, history = _make_behaviors(rng, rows=60)
    c = compile_behaviors(impressions, history)
    ranks = group_items(dense_rank_by_segment(np.round(rng.random(len(c.imp_rev)), 1), c.imp_lens), c.imp_lens)
    preds = [r.tolist() for r in ranks]
    labels = [y.tolist() for y in group_items(c.labels_flat, c.imp_lens)]
    ids = [f"I{i}" for i in range(len(preds))]
    got = metrics.score(preds, labels, imp_ids=ids, debug_dir=tmp_path / "port")
    want = jax_metrics.score(preds, labels, imp_ids=ids, debug_dir=tmp_path / "jax")
    assert got == want
    assert (tmp_path / "port" / "debug_json.json").read_text() == (tmp_path / "jax" / "debug_json.json").read_text()
    row = metrics.score_row(labels[0], preds[0])
    assert row == jax_metrics.score_row(labels[0], preds[0])
