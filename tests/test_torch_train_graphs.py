"""The flat train step's graph cache (``train.graphs``) without a card: its
keys, the order of warm-up, capture and replay, its cap, and its
invalidation by a changed hyperparameter, by new tables and by a restored
state, through ``tests/eager_graphs.py``'s stand-in, which runs the step
eagerly where the card would replay it. The CPU route builds no graphs, and
a restore keeps the optimizer's own ``capturable``."""

import numpy as np
import pytest
import torch

from eager_graphs import EagerGraphs
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.train.graphs import MAX_GRAPHS, hyperparameters, signature
from news_recommendation_project_v2_torch.train.trainer import TowerTrainer, make_optimizer
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = 32
TOWER = dict(kind="latent", reduced_dim=D, num_latents=8, latent_dim_head=16)


def _flat_batch(T=1024, B=64, K=None, lens_dtype=torch.float32):
    """A flat batch's shapes: tok_idx, tok_rows [T], lens, hist_rev, pos_idx
    [B], neg_idx [B] or [B, K], pair_mask [B]."""
    neg = torch.zeros(B, dtype=torch.int32) if K is None else torch.zeros(B, K, dtype=torch.int32)
    return (
        torch.zeros(T, dtype=torch.int32), torch.zeros(T, dtype=torch.int32), torch.zeros(B, dtype=lens_dtype),
        torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32), neg, torch.zeros(B),
    )


@pytest.mark.parametrize(
    "other",
    [dict(T=2048), dict(B=32), dict(K=4), dict(lens_dtype=torch.float64)],
    ids=["token_bucket", "batch_size", "negatives", "dtype"],
)
def test_signature_keys_by_every_shape_and_type(other):
    base = _flat_batch()
    assert signature(base) == signature(tuple(t + 1 for t in base))  # values do not count
    assert signature(_flat_batch(**other)) != signature(base)


class _Counted:
    """A step that counts its calls and returns their number."""

    def __init__(self):
        self.calls = 0

    def __call__(self, batch):
        self.calls += 1
        return torch.tensor(float(self.calls))


def _graphs(cap=MAX_GRAPHS):
    """The stand-in over a one-parameter optimizer, called as a trainer
    calls it: ``graphs(batch)`` steps a ``_Counted`` step."""
    opt = make_optimizer(TrainConfig(), [torch.nn.Parameter(torch.zeros(3))])
    graphs, step = EagerGraphs(opt, torch.device("cpu")), _Counted()
    graphs.cap = cap
    return (lambda batch: graphs(step, batch)), graphs, opt


def test_a_signature_warms_then_captures_then_replays():
    call, graphs, _ = _graphs()
    a, b = _flat_batch(), _flat_batch(T=2048)
    losses = [float(call(x)) for x in (a, a, a, b, a, b, b)]
    assert losses == [1, 2, 3, 4, 5, 6, 7]  # every call steps once
    assert graphs.kinds() == [
        "warm", "capture", "replay", "replay", "warm", "replay", "capture", "replay", "replay",
    ]
    assert set(graphs.graphs) == {signature(a), signature(b)}


@pytest.mark.parametrize("cap", [1, 2])
def test_signatures_past_the_cap_run_eagerly(cap):
    call, graphs, _ = _graphs(cap)
    batches = [_flat_batch(T=1024 << i) for i in range(3)]
    for x in batches + batches:
        call(x)
    assert len(graphs.graphs) == cap
    assert sorted(graphs.graphs) == sorted(signature(x) for x in batches[:cap])
    # Each signature warms on its first call, under the cap or not; on their
    # second the first ``cap`` are captured and the others run eagerly.
    assert graphs.kinds()[:3] == ["warm"] * 3
    eager = [sig for what, sig in graphs.log if what == "eager"]
    assert eager == [signature(x) for x in batches[cap:]]


@pytest.mark.parametrize(
    "change",
    [("lr", 1e-6), ("weight_decay", 0.5), ("betas", (0.8, 0.99)), ("eps", 1e-6), ("max_norm", 0.25)],
    ids=lambda c: c if isinstance(c, str) else "",
)
def test_a_changed_hyperparameter_drops_every_graph(change):
    call, graphs, opt = _graphs()
    a, b = _flat_batch(), _flat_batch(T=2048)
    for x in (a, a, b, b):
        call(x)
    before = hyperparameters(opt)
    key, value = change
    if key == "max_norm":
        opt.max_norm = value
    else:
        opt.param_groups[0][key] = value
    assert hyperparameters(opt) != before
    graphs.log.clear()
    for x in (a, a, b):
        call(x)
    assert graphs.kinds() == ["warm", "capture", "replay", "warm"]
    assert set(graphs.graphs) == {signature(a)}


@pytest.fixture(scope="module")
def data():
    imps, hist, emb = synthetic_learnable_behaviors(
        num_news=200, num_rows=160, dim=D, max_history=120, noise=0.05, seed=3
    )
    ct = compile_behaviors(imps, hist).with_history_view()
    return ct, align_embeddings(ct.news_ids, emb)


def _trainer(data, stand_in: bool, **cfg):
    ct, emb = data
    torch.manual_seed(0)
    tower = build_tower(TowerConfig(**TOWER))
    cfg = TrainConfig(**{"learning_rate": 1e-3, "batch_size": 64, "seed": 0, **cfg})
    trainer = TowerTrainer(tower, ct, emb, cfg=cfg, device="cpu")
    if stand_in:
        trainer._graphs = EagerGraphs(trainer.optimizer, trainer.device)
    return trainer


def _params(trainer):
    return [p.detach().clone() for p in trainer.model.parameters()]


@pytest.mark.parametrize("route", [dict(), dict(flat_train=False, flat_eval=False)], ids=["flat", "padded"])
def test_the_cpu_route_builds_no_graphs(data, route):
    ct, emb = data
    tower = build_tower(TowerConfig(**TOWER))
    trainer = TowerTrainer(tower, ct, emb, cfg=TrainConfig(batch_size=64), device="cpu", **route)
    assert trainer._graphs is None
    assert not any(g["capturable"] for g in trainer.optimizer.param_groups)


@pytest.mark.parametrize("loss", ["margin", "infonce"])
def test_the_trainer_serves_both_buckets_from_its_graphs(data, loss):
    """Through the stand-in, an epoch of batches of T = 1,024 and 2,048 gives
    the eager route's losses and parameters (the stand-in's replays are the
    eager step), with each bucket warmed once and captured once."""
    graphed, eager = _trainer(data, True, loss=loss), _trainer(data, False, loss=loss)
    assert graphed.train_one_epoch() == eager.train_one_epoch()
    assert all(torch.equal(a, b) for a, b in zip(_params(graphed), _params(eager)))
    buckets = {sig[0][0][0] for _, sig in graphed._graphs.log}
    assert buckets == {1024, 2048}
    kinds = graphed._graphs.kinds()
    assert kinds.count("warm") == kinds.count("capture") == 2
    assert kinds.count("replay") == len(kinds) - 2 * 2


def test_new_tables_a_restored_state_and_a_plateau_cut_drop_the_graphs(data, tmp_path):
    """Each of the three replaces what a graph holds: after it the trainer
    warms and captures every bucket again, and its epochs stay the eager
    route's."""
    other = np.roll(data[1], 1, axis=0)
    trainers = []
    for stand_in in (True, False):
        t = _trainer(data, stand_in, plateau_patience=1)
        log = t._graphs.log if stand_in else []
        t.train_one_epoch()
        t.save_training_state(tmp_path / f"state_{stand_in}")
        events = (
            lambda: t.set_tables(other),
            lambda: t.restore_training_state(tmp_path / f"state_{stand_in}"),
            lambda: [t.plateau.update(t.optimizer, m) for m in (1.0, 0.5, 0.5)],
        )
        for event in events:
            event()
            log.clear()
            t.train_one_epoch()
            if stand_in:
                kinds = [what for what, _ in log]
                assert kinds[0] == "warm" and kinds.count("capture") == 2
        assert t.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
        trainers.append(t)
    assert all(torch.equal(a, b) for a, b in zip(*map(_params, trainers)))


def test_a_restore_keeps_the_optimizers_own_capturable(data, tmp_path):
    """A state saved with ``capturable`` set (the card's graphed route)
    restores into the CPU route as a plain optimizer, step counts on the
    host, and resumes as the CPU route's own save does."""
    runs = []
    for flag in (False, True):
        trainer = _trainer(data, False)
        trainer.train_one_epoch()
        trainer.save_training_state(tmp_path / "state")
        if flag:
            state = torch.load(tmp_path / "state", weights_only=True)
            for group in state["opt_state"]["param_groups"]:
                group["capturable"] = True
            torch.save(state, tmp_path / "state")
        resumed = _trainer(data, False)
        resumed.restore_training_state(tmp_path / "state")
        assert not any(g["capturable"] for g in resumed.optimizer.param_groups)
        assert all(s["step"].device.type == "cpu" for s in resumed.optimizer.state.values())
        runs.append((resumed.train_one_epoch(), _params(resumed)))
    (loss0, params0), (loss1, params1) = runs
    assert loss0 == loss1
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))
