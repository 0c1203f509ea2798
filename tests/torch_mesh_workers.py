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
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


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
    """On the card: over gloo, two ranks that share it run the flat and
    padded margin steps on mesh (2, 1) (``run_sharded_steps``); over NCCL,
    a world of one runs the flat step on mesh (1, 1)."""
    mesh = build_mesh(MeshConfig(), backend=backend)
    torch.backends.cuda.matmul.allow_tf32 = False
    kinds = ("flat_margin", "padded_margin") if mesh.size > 1 else ("flat_margin",)
    return dict(backend=torch.distributed.get_backend(), shape=mesh.shape,
                steps={kind: run_sharded_steps(mesh, kind, params, "cuda") for kind in kinds})
