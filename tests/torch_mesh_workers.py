"""Rank workers of the port's multi-rank CPU tests (``test_torch_mesh_*.py``).

``parallel.mesh.launch`` runs them in spawned gloo ranks, so this module
imports no JAX: a rank loads only torch, numpy and the port. Each worker
runs several checks in one spawn and returns plain numpy and Python values,
which the test process compares with the single-rank port and the JAX
package. The fixtures are built here, from seeds, the same in every rank and
in the test process."""

from __future__ import annotations

import numpy as np
import torch

from news_recommendation_project_v2_torch.config import MeshConfig, TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.models import WeightedSumModel, build_tower
from news_recommendation_project_v2_torch.models.convert import (
    classification_head_state_dict_from_jax,
    latent_state_dict_from_jax,
    random_classification_head_params,
    random_latent_params,
)
from news_recommendation_project_v2_torch.models.towers import ClassificationHead
from news_recommendation_project_v2_torch.parallel import (
    batch_sharding,
    build_mesh,
    make_sharded_classification_step,
    make_sharded_flat_tower_train_step,
    make_sharded_joint_train_step,
    make_sharded_tower_train_step,
    shard_news_table,
    table_sharding,
)
from news_recommendation_project_v2_torch.train.step import (
    classification_infonce_loss,
    classification_margin_loss,
    flat_infonce_loss,
    flat_margin_loss,
    joint_margin_loss,
    padded_infonce_loss,
    padded_margin_loss,
)
from news_recommendation_project_v2_torch.train.trainer import (
    ClassificationTrainer,
    ClippedAdamW,
    JointTowerTrainer,
    TowerTrainer,
)

D = 32
TOWER = TowerConfig(kind="latent", reduced_dim=D, num_latents=4, latent_dim_head=8)
STEP_KINDS = ("flat_margin", "flat_infonce", "padded_margin", "padded_infonce", "joint", "classification_margin",
              "classification_infonce")


def learnable(num_news=120, num_rows=150, history_view=True):
    """The data of the JAX package's mesh trainer tests
    (``tests/test_sharding.py``): the compiled rows (a with-history view by
    default) and the aligned table."""
    imps, hist, emb = synthetic_learnable_behaviors(num_news=num_news, num_rows=num_rows, dim=D, noise=0.05)
    c = compile_behaviors(imps, hist)
    if history_view:
        c = c.with_history_view()
    return c, align_embeddings(c.news_ids, emb)


def tower_from(params) -> torch.nn.Module:
    """The latent tower with ``params["tower"]`` (flax-layout numpy)."""
    tower = build_tower(TOWER)
    tower.load_state_dict(latent_state_dict_from_jax(params["tower"]))
    return tower


def head_from(params) -> torch.nn.Module:
    """The content scorer with ``params["head"]`` (flax-layout numpy)."""
    head = ClassificationHead(D, D)
    head.load_state_dict(classification_head_state_dict_from_jax(params["head"]))
    return head


def numpy_params(seed: int = 0) -> dict:
    """Weights drawn with numpy, for runs with no JAX counterpart."""
    rng = np.random.default_rng(seed)
    return dict(tower=random_latent_params(rng, TOWER), head=random_classification_head_params(rng, D, D))


def baseline_scores(num_news: int) -> np.ndarray:
    return np.random.default_rng(0).random(num_news).astype(np.float32)


def _model(kind: str, params) -> torch.nn.Module:
    if kind.startswith("classification"):
        return head_from(params)
    if kind == "joint":
        return torch.nn.ModuleDict({"tower": tower_from(params), "blend": WeightedSumModel()})
    return tower_from(params)


def _loss_and_step(kind: str, m: torch.nn.Module, margin: float):
    """The single-device loss of ``kind`` on module ``m``, and the maker of
    its data-parallel step."""
    infonce = kind.endswith("infonce")
    if kind.startswith("classification"):
        if infonce:
            return (lambda n, q, b: classification_infonce_loss(m, n, b)), (
                lambda mesh: make_sharded_classification_step(mesh, m, margin, True))
        return (lambda n, q, b: classification_margin_loss(m, n, b, margin)), (
            lambda mesh: make_sharded_classification_step(mesh, m, margin))
    if kind == "joint":
        return (lambda n, q, b: joint_margin_loss(m["tower"], n, b, margin, m["blend"], None, None, q)), (
            lambda mesh: make_sharded_joint_train_step(mesh, m["tower"], margin, m["blend"]))
    if kind.startswith("flat"):
        if infonce:
            return (lambda n, q, b: flat_infonce_loss(m, n, b, q)), (
                lambda mesh: make_sharded_flat_tower_train_step(mesh, m, margin, True))
        return (lambda n, q, b: flat_margin_loss(m, n, b, margin, q)), (
            lambda mesh: make_sharded_flat_tower_train_step(mesh, m, margin))
    if infonce:
        return (lambda n, q, b: padded_infonce_loss(m, n, b, None, q)), (
            lambda mesh: make_sharded_tower_train_step(mesh, m, margin, True))
    return (lambda n, q, b: padded_margin_loss(m, n, b, margin, None, q)), (
        lambda mesh: make_sharded_tower_train_step(mesh, m, margin))


def step_batches(kind: str, params, batch_size: int = 40) -> tuple[np.ndarray, list]:
    """The learnable fixture's table and the global numpy batches of
    ``kind`` that its trainer builds: the epoch's first two and its last,
    which holds pad pairs."""
    c, emb = learnable()
    infonce = kind.endswith("infonce")
    cfg = TrainConfig(batch_size=batch_size, seed=0, loss="infonce" if infonce else "margin")
    m = _model(kind, params)
    if kind.startswith("classification"):
        trainer = ClassificationTrainer(m, c, emb, cfg=cfg, device="cpu")
        batches = [tuple(t.numpy() for t in b) for _, b in trainer._host_batches()]
    elif kind == "joint":
        trainer = JointTowerTrainer(m["tower"], c, emb, blend=m["blend"], baseline_train=baseline_scores(c.num_news),
                                    cfg=cfg, flat_eval=False, device="cpu")
        batches = [tuple(t.numpy() for t in b) for _, b in trainer._host_batches()]
    else:
        flat = kind.startswith("flat")
        trainer = TowerTrainer(m, c, emb, cfg=cfg, flat_train=flat, flat_eval=flat, device="cpu")
        batches = list(trainer._epoch_batches_flat() if flat else trainer._epoch_batches())
    mask = batches[-1][5] if kind == "joint" else batches[-1][-1]
    assert mask.min() == 0, "the epoch's last batch must hold pad pairs"
    return emb, [batches[0], batches[1], batches[-1]]


def _tensors(batch, device="cpu") -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch)


def _flat_grad(model) -> torch.Tensor:
    return torch.cat([torch.zeros(p.numel(), device=p.device) if p.grad is None else p.grad.reshape(-1)
                      for p in model.parameters()])


def run_sharded_steps(mesh, kind: str, params, device="cpu") -> dict:
    """Three data-parallel steps of ``kind`` (``ClippedAdamW``) on
    ``device``; before each, the single-device loss and gradient of the
    global batch at the same parameters. Returns the largest loss
    difference, the largest norm-relative gradient difference, and the
    parameters after the steps."""
    emb, batches = step_batches(kind, params)
    margin = TrainConfig().margin
    model = _model(kind, params).to(device)
    _, make_step = _loss_and_step(kind, model, margin)
    step = make_step(mesh)
    table = shard_news_table(mesh, emb, device)
    full = torch.as_tensor(emb, device=device)
    opt = ClippedAdamW(model.parameters(), lr=1e-3, weight_decay=0.01, max_norm=0.5)
    grads = []
    opt.register_step_pre_hook(lambda o, args, kwargs: grads.append(_flat_grad(model).clone()))
    loss_err = grad_err = 0.0
    for b in batches:
        ref = _model(kind, params).to(device)
        ref.load_state_dict(model.state_dict())
        ref_loss, _ = _loss_and_step(kind, ref, margin)
        want = ref_loss(full, full, _tensors(b, device))
        want.backward()
        got = step(opt, table, table, _tensors(step.shard(b), device))
        want_grad = _flat_grad(ref)
        loss_err = max(loss_err, abs(float(got) - float(want.detach())))
        grad_err = max(grad_err, float(torch.linalg.vector_norm(grads[-1] - want_grad) / torch.linalg.vector_norm(want_grad)))
    return dict(loss_err=loss_err, grad_err=grad_err, steps=len(grads),
                params={k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()})


def table_checks(mesh) -> dict:
    """The row-sharded table: this rank's shard (layout and zero padding),
    the sharded gather against the plain one, and the whole table back."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((41, 8)).astype(np.float32)  # 41 rows: padding on every model size > 1
    sh = shard_news_table(mesh, table, "cpu")
    sl = table_sharding(mesh, 41)
    want = np.zeros((sl.stop - sl.start, 8), np.float32)
    real = table[sl.start : min(sl.stop, 41)]
    want[: len(real)] = real
    rows = torch.as_tensor(rng.integers(0, 41, size=200))  # the same rows on every rank of a grid row
    rows[:2] = torch.tensor([0, 40])
    return dict(
        shape=sh.shape,
        shard_equal=bool(np.array_equal(sh.local.numpy(), want)),
        gather_equal=bool(torch.equal(sh.gather(rows), torch.as_tensor(table)[rows])),
        full_equal=bool(torch.equal(sh.full(), torch.as_tensor(table))),
        batch_slice=(batch_sharding(mesh, 8).start, batch_sharding(mesh, 8).stop),
    )


def trainer_runs(mesh, params) -> dict:
    """Each trainer on the mesh: the tower trainer's flat and padded routes
    (two epochs of the learnable fixture, bucketed eval), the joint trainer
    and the content scorer (one epoch each); histories and parameters."""
    c, emb = learnable()
    out = {}
    for name, flat in (("tower_flat", True), ("tower_padded", False)):
        t = TowerTrainer(tower_from(params), c, emb, compiled_val=c, news_emb_val=emb,
                         cfg=TrainConfig(learning_rate=3e-4, num_epochs=2, batch_size=64, seed=0),
                         flat_train=flat, flat_eval=False, mesh=mesh, device="cpu")
        out[name] = (t.train(), _params(t.model))
    cj, embj = learnable(num_news=100, num_rows=120)
    base = baseline_scores(cj.num_news)
    t = JointTowerTrainer(tower_from(params), cj, embj, blend=WeightedSumModel(), baseline_train=base, baseline_val=base,
                          compiled_val=cj, news_emb_val=embj,
                          cfg=TrainConfig(learning_rate=3e-4, num_epochs=1, batch_size=40, seed=0),
                          flat_eval=False, mesh=mesh, device="cpu")
    out["joint"] = (t.train(), _params(t.model))
    cc, embc = learnable(num_news=90, num_rows=110, history_view=False)
    t = ClassificationTrainer(head_from(params), cc, embc, compiled_val=cc, news_emb_val=embc,
                              cfg=TrainConfig(learning_rate=1e-3, num_epochs=1, batch_size=64, seed=0),
                              mesh=mesh, device="cpu")
    out["classification"] = (t.train(), _params(t.model))
    return out


def single_trainer_runs(params) -> dict:
    """``trainer_runs`` without a mesh (the test process's reference)."""
    return trainer_runs(None, params)


def _params(model) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def grid_worker(data: int, model: int, params, with_trainers: bool = True) -> dict:
    """The checks of one mesh shape: the table, every data-parallel step
    against the single-rank step, and (``with_trainers``) the trainers."""
    torch.set_num_threads(1)
    mesh = build_mesh(MeshConfig(data_size=data, model_size=model), backend="gloo")
    out = dict(rank=mesh.rank, coords=(mesh.data_index, mesh.model_index), table=table_checks(mesh))
    out["steps"] = {kind: run_sharded_steps(mesh, kind, params) for kind in STEP_KINDS}
    if with_trainers:
        out["trainers"] = trainer_runs(mesh, params)
    return out



def eval_worker(params, unsorted: dict, config3: dict) -> dict:
    """The checks of a (1, 2) mesh, whose two ranks split the table's rows:
    the table and the steps as ``grid_worker``; the sharded flat eval on
    slots in arbitrary order (``unsorted``: the rows, slots and table, as
    numpy) and, on the learnable fixture, its scores and fused metrics (a
    baseline blended at alpha 0.7); ``score_all_impressions(mesh=)`` by both
    routes; and ``configs.run_config3`` (``config3``: its keyword
    arguments)."""
    from news_recommendation_project_v2_torch.configs import run_config3
    from news_recommendation_project_v2_torch.eval.ranker import history_candidate_slots
    from news_recommendation_project_v2_torch.ops.scoring import score_all_impressions
    from news_recommendation_project_v2_torch.parallel.flat_eval import ShardedFlatEvalPlan, ShardedMetricsPlan

    torch.set_num_threads(1)
    mesh = build_mesh(MeshConfig(data_size=1, model_size=2), backend="gloo")
    out = dict(rank=mesh.rank, coords=(mesh.data_index, mesh.model_index), table=table_checks(mesh))
    out["steps"] = {kind: run_sharded_steps(mesh, kind, params) for kind in STEP_KINDS}
    tower = tower_from(params).eval()
    u = unsorted
    plan = ShardedFlatEvalPlan(mesh, u["hist_rev"], u["hist_lens"], u["cand_rev"], u["cand_row"], chunk_tokens=32,
                               cand_chunk=16, device="cpu")
    out["unsorted_scores"], out["unsorted_share"] = plan.score(tower, u["table"]), plan.token_share
    c, emb = learnable(num_news=100, num_rows=90)
    slots, cand_rows = history_candidate_slots(c)
    plan = ShardedFlatEvalPlan(mesh, c.hist_rev, c.hist_lens, c.imp_rev[slots], cand_rows, chunk_tokens=64,
                               cand_chunk=32, device="cpu")
    base = baseline_scores(c.num_news)[c.imp_rev]
    mplan = ShardedMetricsPlan(plan, c.imp_lens, c.labels_flat, hist_slots=slots, baseline_slots=base, alpha=0.7)
    out["scores"], out["metrics"] = plan.score(tower, emb), plan.metrics(tower, emb, mplan)
    out["impressions"] = mplan.num_impressions
    args = (tower, emb, c.hist_rev, c.hist_lens, c.imp_rev[slots], cand_rows)
    out["scores_flat"] = score_all_impressions(*args, flat_tokens=True, flat_max_len=600, mesh=mesh, device="cpu")
    out["scores_bucketed"] = score_all_impressions(*args, mesh=mesh, device="cpu")
    out["config3"] = run_config3(**config3, device="cpu")
    return out


def cuda_worker(params, backend: str) -> dict:
    """On the card: over gloo, two ranks that share it run the flat margin
    and InfoNCE steps and the padded margin step on mesh (2, 1)
    (``run_sharded_steps``); over NCCL, a world of one runs the flat step on
    mesh (1, 1)."""
    mesh = build_mesh(MeshConfig(), backend=backend)
    torch.backends.cuda.matmul.allow_tf32 = False
    kinds = ("flat_margin", "flat_infonce", "padded_margin") if mesh.size > 1 else ("flat_margin",)
    return dict(backend=torch.distributed.get_backend(), shape=mesh.shape,
                steps={kind: run_sharded_steps(mesh, kind, params, "cuda") for kind in kinds})


# ---------------------------------------------------------------------------
# Multi-GPU part 2: the end-to-end path on a mesh, the forward functions,
# config[4] and mesh serving
# ---------------------------------------------------------------------------

# The routes of the JAX package's ``test_mesh_e2e_trainer_matches_single_device``:
# (device_store, shard_store, loss).
E2E_ROUTES = {
    "streamed": (False, False, "margin"),
    "replicated": (True, False, "margin"),
    "sharded": (True, True, "margin"),
    "sharded_infonce": (True, True, "infonce"),
}
E2E_TRAIN = dict(num_neg_per_pos=3, learning_rate=1e-4, num_epochs=1, batch_size=32, seed=0)
E2E_MAX_LEN = 8
# The news hold 2-5 tokens: one bucket of 8 (the class's start at 64 would
# only pad), set on the JAX trainer too.
E2E_TOKEN_BUCKETS = (8,)


def e2e_fixture():
    """That test's data: 80 news and 80 rows at d = 32, each news item 2-5
    token states scattered about its embedding. Returns the behaviors'
    strings, the per-news token arrays, the compiled rows and the store."""
    from news_recommendation_project_v2_torch.ops.encode import TokenStore

    imps, hist, emb = synthetic_learnable_behaviors(num_news=80, num_rows=80, dim=D, noise=0.05)
    c = compile_behaviors(imps, hist).with_history_view()
    aligned = align_embeddings(c.news_ids, emb)
    rng = np.random.default_rng(1234)
    arrays = [
        aligned[i][None] + rng.standard_normal((int(rng.integers(2, 6)), D)).astype(np.float32) * 0.05
        for i in range(c.num_news)
    ]
    return imps, hist, arrays, c, TokenStore.from_ragged(arrays)


def e2e_params() -> dict:
    """The token encoder's and the tower's weights, drawn with numpy."""
    from news_recommendation_project_v2_torch.models.convert import random_e2e_params

    return random_e2e_params(np.random.default_rng(3), D, 1, TOWER)


def e2e_modules(params, device="cpu") -> torch.nn.ModuleDict:
    """``TokenAttentionPool`` and the tower with ``params``, dropout off."""
    from news_recommendation_project_v2_torch.models import TokenAttentionPool
    from news_recommendation_project_v2_torch.models.convert import e2e_state_dict_from_jax

    model = torch.nn.ModuleDict({"token_encoder": TokenAttentionPool(D, 1), "tower": build_tower(TOWER)})
    model.load_state_dict(e2e_state_dict_from_jax(params))
    for layer in model["token_encoder"].encoder.layer:
        layer.dropout_rate = layer.g_mlp.dropout_rate = 0.0
    return model.to(device)


def e2e_trainer(mesh, route: str, params, device="cpu"):
    from news_recommendation_project_v2_torch.train.trainer import EndToEndTrainer

    device_store, shard_store, loss = E2E_ROUTES[route]
    _, _, _, c, store = e2e_fixture()
    model = e2e_modules(params, device)
    t = EndToEndTrainer(
        model["token_encoder"], model["tower"], c, store, cfg=TrainConfig(loss=loss, **E2E_TRAIN),
        max_token_len=E2E_MAX_LEN, mesh=mesh, device_store=device_store,
        shard_store=shard_store if mesh is not None else None, device=device,
    )
    t.TOKEN_BUCKETS = E2E_TOKEN_BUCKETS
    return t


def e2e_run(mesh, route: str, params) -> dict:
    """One epoch of ``EndToEndTrainer`` (with a mesh, the route's store):
    every step's loss, the epoch's history and the weights after it."""
    t = e2e_trainer(mesh, route, params)
    losses = []

    def recorded(fn):
        def call(*args):
            loss = fn(*args)
            losses.append(float(loss.detach()))
            return loss

        call.shard = getattr(fn, "shard", None)  # the trainer shards its batches with the step's rule
        return call

    if t._mesh_step is not None:
        t._mesh_step = recorded(t._mesh_step)
    else:
        t._loss = recorded(t._loss)
    history = t.train()
    out = dict(losses=losses, history=history, params=_params(t.model), device_store=t.device_store,
               store_sharded=t.store_sharded)
    if t.store_sharded:
        out["shard_rows"], out["store_rows"] = t._dev_states.rows_per_shard, t._dev_states.shape[0]
    return out


def e2e_step_checks(mesh, route: str, params, device="cpu") -> dict:
    """Three data-parallel steps of the route (the epoch's first two
    batches and its last, with pad pairs), each against one rank's loss and
    gradient of the global batch at the same weights: the largest loss
    difference, the largest norm-relative gradient difference, the weights
    after the steps."""
    from news_recommendation_project_v2_torch.train.step import (
        e2e_infonce_loss,
        e2e_infonce_loss_gathered,
        e2e_margin_loss,
        e2e_margin_loss_gathered,
    )

    t = e2e_trainer(mesh, route, params, device)
    device_store, _, loss = E2E_ROUTES[route]
    batches = list(t._epoch_batches())
    assert batches[-1][-1].min() == 0, "the epoch's last batch must hold pad pairs"
    full = torch.as_tensor(t.store.states, device=device)
    margin = t.cfg.margin
    grads = []
    t.optimizer.register_step_pre_hook(lambda o, args, kwargs: grads.append(_flat_grad(t.model).clone()))
    loss_err = grad_err = 0.0
    for b in (batches[0], batches[1], batches[-1]):
        ref = e2e_modules(params, device)
        ref.load_state_dict(t.model.state_dict())
        enc, tower, whole = ref["token_encoder"], ref["tower"], _tensors(b, device)
        if device_store:
            want = (e2e_infonce_loss_gathered(enc, tower, full, whole) if loss == "infonce"
                    else e2e_margin_loss_gathered(enc, tower, full, whole, margin))
        else:
            want = e2e_infonce_loss(enc, tower, whole) if loss == "infonce" else e2e_margin_loss(enc, tower, whole, margin)
        want.backward()
        got = t._mesh_step(t.optimizer, t._dev_states, None, _tensors(t._mesh_step.shard(b), device))
        want_grad = _flat_grad(ref)
        loss_err = max(loss_err, abs(float(got) - float(want.detach())))
        grad_err = max(grad_err, float(torch.linalg.vector_norm(grads[-1] - want_grad) / torch.linalg.vector_norm(want_grad)))
    return dict(loss_err=loss_err, grad_err=grad_err, steps=len(grads), params=_params(t.model))


def materialize_fixture():
    """The JAX package's mesh materialize test's data: 37 news of 2-6 token
    states at d = 32, and a one-layer ``TokenAttentionPool``'s weights."""
    from news_recommendation_project_v2_torch.models.convert import random_token_attention_pool_params
    from news_recommendation_project_v2_torch.ops.encode import TokenStore

    rng = np.random.default_rng(37)
    arrays = [rng.standard_normal((int(rng.integers(2, 7)), D)).astype(np.float32) for _ in range(37)]
    return arrays, TokenStore.from_ragged(arrays), random_token_attention_pool_params(rng, D, 1)


def materialize_checks(mesh, device="cpu") -> dict:
    """``materialize_from_token_store_mesh`` from the store replicated on
    every rank and from the ``ShardedStore`` (batch 16, tokens 8), and the
    sharded store's layout and gather against the plain one."""
    from news_recommendation_project_v2_torch.models import TokenAttentionPool
    from news_recommendation_project_v2_torch.models.convert import token_attention_pool_state_dict_from_jax
    from news_recommendation_project_v2_torch.ops.encode import materialize_from_token_store_mesh
    from news_recommendation_project_v2_torch.parallel import shard_token_store_states, store_sharding

    _, store, params = materialize_fixture()
    enc = TokenAttentionPool(D, 1)
    enc.load_state_dict(token_attention_pool_state_dict_from_jax(params))
    enc = enc.to(device)
    states = store.states
    sharded = shard_token_store_states(mesh, states, device)
    out = {}
    for name, dev in (("replicated", torch.as_tensor(states, device=device)), ("sharded", sharded)):
        out[name] = materialize_from_token_store_mesh(
            enc, store, mesh, dev, batch_size=16, max_token_len=8, token_buckets=(8,), device=device
        )
    sl = store_sharding(mesh, len(states))
    want = np.zeros((sl.stop - sl.start, D), np.float32)
    real = states[sl.start : min(sl.stop, len(states))]
    want[: len(real)] = real
    grids = torch.as_tensor(np.random.default_rng(9).integers(0, len(states), size=(mesh.data_size, 5, 4)), device=device)
    plain = torch.as_tensor(states, device=device)[grids[mesh.data_index]]
    out["store"] = dict(
        shape=sharded.shape, rows_per_shard=sharded.rows_per_shard,
        shard_equal=bool(np.array_equal(sharded.local.cpu().numpy(), want)),
        gather_equal=bool(torch.equal(sharded.gather(grids), plain)),
    )
    return out


def e2e_worker(shapes: list, params) -> dict:
    """The e2e checks on each mesh shape of this world: every route's steps
    against one rank and its epoch, and the materialize checks."""
    torch.set_num_threads(1)
    out = {}
    for data, model in shapes:
        mesh = build_mesh(MeshConfig(data_size=data, model_size=model), backend="gloo")
        out[(data, model)] = dict(
            steps={route: e2e_step_checks(mesh, route, params) for route in E2E_ROUTES},
            runs={route: e2e_run(mesh, route, params) for route in E2E_ROUTES},
            materialize=materialize_checks(mesh),
            forward=forward_checks(mesh) if (data, model) == (2, 2) else None,
            serve=serve_checks(mesh) if (data, model) == (2, 2) else None,
        )
    return out


# -- the forward functions ------------------------------------------------------

SMALL_ENCODER = dict(vocab_size=96, hidden_dim=32, num_heads=2, intermediate_dim=64, max_position=20,
                     compute_dtype="float32")
# NV-Embed's layout at a small width: a decoder backbone and the latent head.
SMALL_NV_EMBED = dict(arch="qwen2", vocab_size=96, hidden_dim=32, num_layers=1, num_heads=4, num_kv_heads=2,
                      intermediate_dim=64, max_position=20, compute_dtype="float32", bidirectional=True,
                      latent_pool=True, latent_pool_num_latents=8, latent_pool_heads=2, latent_pool_dim_head=16,
                      qkv_bias=True)
FINAL_ATTENTION = TowerConfig(kind="final_attention", reduced_dim=D, embedding_dim=D, hidden_dim=64, dropout_rate=0.0)


def encoder_from(cfg_kwargs: dict, seed: int = 0):
    """A ``NewsEncoder`` with ``random_encoder_params(cfg, seed)``, and its
    config."""
    from news_recommendation_project_v2_torch.config import EncoderConfig
    from news_recommendation_project_v2_torch.models.convert import encoder_state_dict_from_jax, random_encoder_params
    from news_recommendation_project_v2_torch.models.news_encoder import NewsEncoder

    cfg = EncoderConfig(**cfg_kwargs)
    enc = NewsEncoder(cfg)
    enc.load_state_dict(encoder_state_dict_from_jax(random_encoder_params(cfg, seed), cfg))
    return enc.eval(), cfg


def sequence_inputs():
    """The JAX test's sequence-sharded inputs: B = 8, L = 16, d = 32."""
    rng = np.random.default_rng(1234)
    emb = rng.standard_normal((8, 16, D)).astype(np.float32)
    mask = (rng.random((8, 16)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    return emb * mask[..., None], mask


def encode_texts():
    return [f"document number {i}" for i in range(8)], ["alpha beta gamma delta", "tiny text"]


def scoring_inputs():
    """The JAX test's scoring inputs: a 40-row table, 8 histories of 8, 24
    candidate slots."""
    rng = np.random.default_rng(1234)
    table = rng.standard_normal((40, D)).astype(np.float32)
    return dict(table=table, hist_idx=rng.integers(0, 40, size=(8, 8)), hist_mask=np.ones((8, 8), np.float32),
                cand_rev=rng.integers(0, 40, size=24), cand_row=rng.integers(0, 8, size=24))


def forward_checks(mesh, device="cpu") -> dict:
    """The sequence-sharded tower (latent and final_attention), the sharded
    encode, the tensor-parallel encoder (BERT/e5 layout and NV-Embed's) and
    the sharded scoring on ``mesh``, each rank's whole output."""
    from news_recommendation_project_v2_torch.models.convert import tower_state_dict_from_jax, random_tower_params
    from news_recommendation_project_v2_torch.models.news_encoder import HashTokenizer
    from news_recommendation_project_v2_torch.parallel import (
        make_sequence_sharded_tower_fn,
        make_sharded_encode_fn,
        make_sharded_scoring_fn,
        shard_encoder_params_tp,
    )

    emb, mask = sequence_inputs()
    latent = tower_from(numpy_params()).eval().to(device)
    out = {"seq_latent": make_sequence_sharded_tower_fn(mesh, latent)(emb, mask).cpu().numpy()}
    fa = build_tower(FINAL_ATTENTION)
    fa.load_state_dict(tower_state_dict_from_jax("final_attention", random_tower_params(np.random.default_rng(4), FINAL_ATTENTION)))
    out["seq_final_attention"] = make_sequence_sharded_tower_fn(mesh, fa.eval().to(device))(emb, mask).cpu().numpy()
    texts, tp_texts = encode_texts()
    enc, _ = encoder_from(dict(SMALL_ENCODER, num_layers=1))
    out["encode"] = make_sharded_encode_fn(mesh, enc.to(device))(*HashTokenizer(96, 12)(texts)).cpu().numpy()
    for name, cfg in (("tp_bert", dict(SMALL_ENCODER, num_layers=2)), ("tp_nv_embed", SMALL_NV_EMBED)):
        enc, _ = encoder_from(cfg)
        tp = shard_encoder_params_tp(mesh, enc, device)
        with torch.inference_mode():
            got = tp(*(torch.as_tensor(a, device=device) for a in HashTokenizer(96, 12)(tp_texts)))
        local = {k: tuple(v.shape) for k, v in tp.state_dict().items()}
        out[name] = dict(out=got.cpu().numpy(), split=tp.split_leaves, local=local,
                         whole={k: tuple(v.shape) for k, v in enc.state_dict().items()})
    s = scoring_inputs()
    out["scoring"] = make_sharded_scoring_fn(mesh, latent)(
        shard_news_table(mesh, s["table"], device), s["hist_idx"], s["hist_mask"], s["cand_rev"], s["cand_row"]
    ).cpu().numpy()
    return out


def config4_fixture():
    """``tests/test_baseline_configs.py::test_config4_multihost_pipeline_runs``'s
    data at d = 16: the compiled rows and their news texts' tokens."""
    from news_recommendation_project_v2_torch.models.news_encoder import HashTokenizer

    imps, hist, _ = synthetic_learnable_behaviors(num_news=40, num_rows=40, dim=16)
    c = compile_behaviors(imps, hist)
    ids, mask = HashTokenizer(96, 8)([f"news article {n}" for n in c.news_ids])
    return imps, hist, c, ids, mask


CONFIG4_ENCODER = dict(vocab_size=96, hidden_dim=16, num_layers=1, num_heads=2, intermediate_dim=32, max_position=16,
                       compute_dtype="float32")
CONFIG4_TRAIN = dict(learning_rate=3e-4, num_epochs=1, batch_size=32, seed=0)
CONFIG4_TOWER = dict(kind="latent", reduced_dim=16, num_latents=4, latent_dim_head=8)


def config4_runs(data: int, model: int) -> dict:
    """``run_config4`` on the (data, model) mesh of this world, without and
    with the tower's training."""
    from news_recommendation_project_v2_torch.configs import run_config4

    _, _, c, ids, mask = config4_fixture()
    enc, _ = encoder_from(CONFIG4_ENCODER)
    mesh_cfg = MeshConfig(data_size=data, model_size=model)
    return dict(
        config0=run_config4(c, ids, mask, enc, mesh_cfg=mesh_cfg, device="cpu"),
        config3=run_config4(c, ids, mask, enc, mesh_cfg=mesh_cfg, train_cfg=TrainConfig(**CONFIG4_TRAIN),
                            tower_cfg=TowerConfig(**CONFIG4_TOWER), device="cpu"),
    )


def encode_worker(shapes: list) -> dict:
    """The forward checks and ``run_config4`` on each mesh shape of this
    world."""
    torch.set_num_threads(1)
    out = {}
    for data, model in shapes:
        mesh = build_mesh(MeshConfig(data_size=data, model_size=model), backend="gloo")
        out[(data, model)] = dict(forward=forward_checks(mesh), config4=config4_runs(data, model))
    return out


# -- mesh serving ------------------------------------------------------------

SERVE_NEWS = 501  # no multiple of the model axis: the shards pad


def serve_table() -> tuple[np.ndarray, list]:
    return np.random.default_rng(11).standard_normal((SERVE_NEWS, D)).astype(np.float32), [f"N{i}" for i in range(SERVE_NEWS)]


def serve_requests() -> list:
    """20 requests of 1-39 history ids and 1-89 candidates (a few unknown),
    and two with more candidates than the largest bucket."""
    rng = np.random.default_rng(12)

    def ids(n, hi):
        return [f"N{i}" for i in rng.integers(0, hi, n)]

    reqs = [(ids(int(rng.integers(1, 40)), SERVE_NEWS), ids(int(rng.integers(1, 90)), SERVE_NEWS + 9)) for _ in range(20)]
    return reqs + [(ids(30, SERVE_NEWS), ids(700, SERVE_NEWS)) for _ in range(2)]


def serve_calls(ranker) -> dict:
    """The calls rank 0 answers: every request by ``rank``, all of them by
    ``rank_batch``, and ``retrieve`` at k = 7 and past the table."""
    reqs = serve_requests()
    return dict(
        rank=[ranker.rank(*r) for r in reqs], rank_batch=ranker.rank_batch(reqs),
        retrieve=[ranker.retrieve(reqs[0][0], k=7), ranker.retrieve(reqs[1][0], k=SERVE_NEWS + 50)],
    )


def serve_ranker(mesh, device="cpu"):
    from news_recommendation_project_v2_torch.serve import Ranker

    table, ids = serve_table()
    return Ranker(tower_from(numpy_params()), table, ids, mesh=mesh, device=device)


def serve_checks(mesh, device="cpu") -> dict:
    """``Ranker(mesh=)`` on ``mesh``: rank 0's answers and the followers'
    count of served calls."""
    ranker = serve_ranker(mesh, device)
    if mesh.rank == 0:
        out = serve_calls(ranker)
        ranker.close()
        return out
    return dict(served=ranker.follow())


def dead_leader_check(timeout: float = 3.0) -> dict:
    """A follower whose rank 0 sends nothing fails on the mesh's timeout
    instead of hanging: rank 0 builds the ranker and stays silent for
    twice the timeout; each follower returns what ``follow()`` raised and
    after how long."""
    import time
    from datetime import timedelta

    mesh = build_mesh(MeshConfig(data_size=1, model_size=2), backend="gloo", timeout=timedelta(seconds=timeout))
    ranker = serve_ranker(mesh)
    if mesh.rank == 0:
        time.sleep(2 * timeout)
        return dict(leader=True)
    t0 = time.monotonic()
    try:
        ranker.follow()
    except RuntimeError as e:
        return dict(error=type(e).__name__, seconds=time.monotonic() - t0)
    return dict(error=None, seconds=time.monotonic() - t0)


KEEP_ALIVE_INTERVAL = 0.01
KEEP_ALIVE_CALLS = 3  # rank_batch calls served while the beats fire


def keep_alive_worker() -> dict:
    """``Ranker.keep_alive`` beside served calls on mesh (1, 2): rank 0
    beats every 0.01 s, answers ``KEEP_ALIVE_CALLS`` ``rank_batch`` calls
    of 4 requests with beats between them, and closes while the beat thread
    is inside one beat's tail (after the empty call, before its next wait;
    a thread the scheduler has not run yet, as under a loaded host). Rank 0
    returns whether the thread had ended when ``close()`` returned and the
    count of calls and beats it sent; the follower the count
    ``follow()`` returned."""
    import threading
    import time

    from news_recommendation_project_v2_torch import serve

    torch.set_num_threads(1)
    mesh = build_mesh(MeshConfig(data_size=1, model_size=2), backend="gloo")
    table, ids = serve_table()
    sent = {"calls": 0, "beats": 0}
    in_tail = threading.Event()

    class Counted(serve.Ranker):
        def _call(self, op, arrays=(), k=0):
            out = super()._call(op, arrays, k)
            if op == serve._NOOP and threading.current_thread().name == "ranker-keep-alive":
                sent["beats"] += 1
                in_tail.set()
                time.sleep(0.5)
            elif op in (serve._SCORE, serve._RETRIEVE):
                sent["calls"] += 1
            return out

    ranker = Counted(tower_from(numpy_params()), table, ids, mesh=mesh, device="cpu")
    if mesh.rank != 0:
        return dict(served=ranker.follow())
    def next_beat_tail():
        in_tail.clear()
        if not in_tail.wait(30):
            raise TimeoutError("no beat within 30 s")

    reqs = serve_requests()[:4]
    ranker.keep_alive(KEEP_ALIVE_INTERVAL)
    answers = []
    for _ in range(KEEP_ALIVE_CALLS):
        next_beat_tail()
        answers.append(ranker.rank_batch(reqs))
    next_beat_tail()
    ranker.close()
    beating = [t for t in threading.enumerate() if t.name == "ranker-keep-alive"]
    return dict(thread_ended=not beating, sent=sent, answers=answers)


def serve_worker(shapes: list) -> dict:
    """Mesh serving on each mesh shape of this world, the sharded scoring
    there, then the silent leader."""
    torch.set_num_threads(1)
    out = {}
    for data, model in shapes:
        mesh = build_mesh(MeshConfig(data_size=data, model_size=model), backend="gloo")
        s = scoring_inputs()
        from news_recommendation_project_v2_torch.parallel import make_sharded_scoring_fn

        scores = make_sharded_scoring_fn(mesh, tower_from(numpy_params()).eval())(
            shard_news_table(mesh, s["table"], "cpu"), s["hist_idx"], s["hist_mask"], s["cand_rev"], s["cand_row"]
        ).numpy()
        out[(data, model)] = dict(serve=serve_checks(mesh), scoring=scores)
    out["dead_leader"] = dead_leader_check()
    return out


def cuda_part2_worker(backend: str) -> dict:
    """On the card, float32 and TF32 off: the e2e steps of every route, the
    materialize checks, the forward functions and mesh serving on mesh
    (1, world) (two gloo ranks sharing the card split the model axis;
    NCCL runs a world of one), each next to the same computed by one
    device on the card."""
    from news_recommendation_project_v2_torch.ops.encode import materialize_from_token_store
    from news_recommendation_project_v2_torch.models import TokenAttentionPool
    from news_recommendation_project_v2_torch.models.convert import token_attention_pool_state_dict_from_jax
    from news_recommendation_project_v2_torch.models.news_encoder import HashTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(MeshConfig(data_size=1, model_size=torch.distributed.get_world_size()), backend=backend)
    params = e2e_params()
    out = dict(backend=torch.distributed.get_backend(), shape=mesh.shape)
    out["steps"] = {route: e2e_step_checks(mesh, route, params, "cuda") for route in E2E_ROUTES}
    m = materialize_checks(mesh, "cuda")
    _, store, enc_params = materialize_fixture()
    enc = TokenAttentionPool(D, 1)
    enc.load_state_dict(token_attention_pool_state_dict_from_jax(enc_params))
    want = materialize_from_token_store(enc.cuda(), store, batch_size=16, max_token_len=8, token_buckets=(8,), device="cuda")
    out["materialize"] = {k: float(np.abs(m[k] - want).max()) for k in ("replicated", "sharded")}
    out["store"] = m["store"]
    f = forward_checks(mesh, "cuda")
    emb, mask = sequence_inputs()
    with torch.inference_mode():
        latent = tower_from(numpy_params()).eval().cuda()
        want_seq = latent(torch.as_tensor(emb).cuda(), torch.as_tensor(mask).cuda()).cpu().numpy()
        enc1, _ = encoder_from(dict(SMALL_ENCODER, num_layers=1))
        want_enc = enc1.cuda()(*(torch.as_tensor(a).cuda() for a in HashTokenizer(96, 12)(encode_texts()[0]))).cpu().numpy()
        tp_want = {}
        for name, cfg in (("tp_bert", dict(SMALL_ENCODER, num_layers=2)), ("tp_nv_embed", SMALL_NV_EMBED)):
            e, _ = encoder_from(cfg)
            tp_want[name] = e.cuda()(*(torch.as_tensor(a).cuda() for a in HashTokenizer(96, 12)(encode_texts()[1]))).cpu().numpy()
    out["forward"] = dict(
        seq_latent=float(np.abs(f["seq_latent"] - want_seq).max()),
        encode=float(np.abs(f["encode"] - want_enc).max()),
        **{name: float(np.abs(f[name]["out"] - tp_want[name]).max()) for name in tp_want},
        split={name: f[name]["split"] for name in tp_want},
    )
    out["serve"] = serve_checks(mesh, "cuda")
    if mesh.rank == 0:
        out["serve_single"] = serve_calls(serve_ranker(None, "cuda"))
    return out
