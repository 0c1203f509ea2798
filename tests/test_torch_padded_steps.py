"""The port's padded train steps (``train.step``: the tower's margin and
InfoNCE steps over padded unique histories, the joint step with a blend
and/or a reducer, the content scorer's margin and InfoNCE steps) against the
JAX package's (``train/step.py``) on the same numpy-seeded weights and
batches, on the CPU, with dropout off; and ``ClippedAdamW`` against optax on
a tower with inert parameters.

The JAX losses are composed from the JAX package's own pieces as its step
factories compose them, without the optimizer. The port's gradients come
back to the JAX layout through the JAX package's converters. Both compute
in float32 and sum in other orders: losses within 1e-6, each gradient
within a norm-relative 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.models import convert_towers as jcv
from news_recommendation_project_v2_tpu.models import towers as jax_towers
from news_recommendation_project_v2_tpu.train import losses as jax_losses
from news_recommendation_project_v2_tpu.train import step as jax_step
from news_recommendation_project_v2_tpu.train.trainer import make_optimizer as jax_make_optimizer
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.models import build_tower, convert, towers
from news_recommendation_project_v2_torch.train import step
from news_recommendation_project_v2_torch.train.trainer import make_optimizer
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D, NUM_NEWS, B, U, L, K = 32, 150, 24, 14, 16, 4
CFGS = {
    "latent": TowerConfig(kind="latent", reduced_dim=D, embedding_dim=D, num_latents=8, num_heads=2, latent_dim_head=16),
    "final_attention": TowerConfig(kind="final_attention", reduced_dim=D, embedding_dim=D, hidden_dim=64, dropout_rate=0.0),
    "transformer": TowerConfig(kind="transformer", reduced_dim=D, embedding_dim=D, num_layers=2, dropout_rate=0.0),
}
CONVERT = {
    "latent": jcv.convert_latent_attention,
    "final_attention": jcv.convert_final_attention,
    "transformer": lambda sd: jcv.convert_transformer_tower(sd, num_layers=_layers(sd)),
}


def _layers(sd) -> int:
    return len({k.split(".")[2] for k in sd if k.startswith("encoder.layer.")})


def _jax_cfg(cfg: TowerConfig) -> JaxTowerConfig:
    fields = {f.name for f in dataclasses.fields(JaxTowerConfig)}
    return JaxTowerConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})


def _batch(seed: int, infonce: bool = False, extras: bool = False) -> tuple:
    """A padded batch as ``TowerTrainer._epoch_batches`` builds one: U
    deduped histories of 1 to L clicks padded to L, rows past U all pad;
    20 real pairs and 4 pad pairs; InfoNCE negatives with -1 pads."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, U)
    lens[0] = L
    hist_idx = np.zeros((B, L), np.int32)
    hist_mask = np.zeros((B, L), np.float32)
    for r, n in enumerate(lens):
        hist_idx[r, :n] = rng.integers(0, NUM_NEWS, n)
        hist_mask[r, :n] = 1.0
    real = 20
    rev = np.pad(rng.integers(0, U, real), (0, B - real)).astype(np.int32)
    pos = np.pad(rng.integers(0, NUM_NEWS, real), (0, B - real)).astype(np.int32)
    if infonce:
        neg = rng.integers(0, NUM_NEWS, (B, K)).astype(np.int32)
        neg[rng.random((B, K)) < 0.25] = -1
        neg[real:] = -1
    else:
        neg = np.pad(rng.integers(0, NUM_NEWS, real), (0, B - real)).astype(np.int32)
    mask = np.pad(np.ones(real, np.float32), (0, B - real))
    batch = (hist_idx, hist_mask, rev, pos, neg, mask)
    if extras:
        base = rng.uniform(-1, 1, NUM_NEWS).astype(np.float32)
        batch += (base[pos], base[neg])
    return batch


@pytest.fixture(scope="module")
def emb():
    return np.random.default_rng(0).standard_normal((NUM_NEWS, D)).astype(np.float32)


def _tower(kind, seed=1):
    cfg = CFGS[kind]
    params = convert.random_tower_params(np.random.default_rng(seed), cfg)
    tower = build_tower(cfg)
    tower.load_state_dict(convert.tower_state_dict_from_jax(kind, params), strict=True)
    return tower, params


def _grads(module, to_jax):
    """The port's gradients in the JAX layout, a parameter without one as
    zeros."""
    return to_jax({n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy() for n, p in module.named_parameters()})


def _norm_rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / max(np.linalg.norm(want), 1e-30))


def _assert_grads(got_tree, want_tree, zero: tuple = ()):
    """Each leaf within a norm-relative 1e-5; the leaves named in ``zero``
    have a gradient of 0 up to rounding in both (no norm-relative error
    exists there), and are held under 1e-6 in norm."""
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    assert len(got) == len(want) > 0
    for path, g in got:
        name = jax.tree_util.keystr(path)
        if any(z in name for z in zero):
            assert np.linalg.norm(g) < 1e-6 and np.linalg.norm(want[path]) < 1e-6, name
        else:
            assert _norm_rel(g, want[path]) <= 1e-5, name


def _jax_users(apply, p, news, hist_idx, hist_mask, reduce_apply=None, rp=None):
    gathered = news[hist_idx]
    if reduce_apply is not None:
        gathered = reduce_apply(rp, gathered)
    gathered = gathered * hist_mask[..., None].astype(gathered.dtype)
    return apply(p, gathered, hist_mask, deterministic=False, rngs={"dropout": jax.random.key(0)})


def _jax_tower_loss(apply, news, batch, infonce: bool):
    """``make_tower_train_step`` / ``make_tower_infonce_step``'s loss."""
    hist_idx, hist_mask, rev, pos, neg, mask = map(jnp.asarray, batch)

    def loss_fn(p):
        u = _jax_users(apply, p, news, hist_idx, hist_mask)[rev]
        pos_scores = jax_step.safe_cosine(u, news[pos])
        if not infonce:
            return jax_losses.margin_ranking_loss(pos_scores, jax_step.safe_cosine(u, news[neg]), 2.0, mask)
        neg_e = news[jnp.maximum(neg, 0)]
        un = jnp.sqrt((u * u).sum(-1, keepdims=True) + 1e-16)
        nn_ = jnp.sqrt((neg_e * neg_e).sum(-1) + 1e-16)
        neg_scores = (u[:, None, :] * neg_e).sum(-1) / (un * nn_)
        return jax_losses.infonce_loss(pos_scores, neg_scores, (neg >= 0).astype(jnp.float32), 1.0, mask)

    return loss_fn


@pytest.mark.parametrize("infonce", [False, True], ids=["margin", "infonce"])
@pytest.mark.parametrize("kind", list(CFGS))
def test_tower_step_loss_and_gradients_match_jax(emb, kind, infonce):
    batch = _batch(1, infonce)
    tower, params = _tower(kind)
    tb = tuple(map(torch.from_numpy, batch))
    news = torch.from_numpy(emb)
    loss = step.padded_infonce_loss(tower, news, tb) if infonce else step.padded_margin_loss(tower, news, tb, 2.0)
    loss.backward()
    apply = jax_build_tower(_jax_cfg(CFGS[kind])).apply
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_tower_loss(apply, jnp.asarray(emb), batch, infonce)))(
        jax.tree.map(jnp.asarray, params)
    )
    assert abs(loss.item() - float(want_loss)) <= 1e-6
    # The readout normalises exp(w) per dimension over the history, so the
    # bias of w cancels (but for the 1e-10 guard).
    zero = ("['linear1']['bias']",) if kind == "transformer" else ()
    _assert_grads(_grads(tower, CONVERT[kind]), want_grads, zero)


def _joint_modules(blend: bool, reduce: bool):
    rng = np.random.default_rng(4)
    tower, tparams = _tower("final_attention")
    mods, params, to_jax = {"tower": tower}, {"tower": tparams}, {"tower": CONVERT["final_attention"]}
    if blend:
        mods["blend"], params["blend"] = towers.WeightedSumModel(), convert.random_weighted_sum_params(rng)
        mods["blend"].load_state_dict(convert.weighted_sum_state_dict_from_jax(params["blend"]))
        to_jax["blend"] = jcv.convert_weighted_sum
    if reduce:
        mods["reduce"], params["reduce"] = towers.ReducingModel(D, D), convert.random_reducing_params(rng, D, D)
        mods["reduce"].load_state_dict(convert.reducing_state_dict_from_jax(params["reduce"]))
        to_jax["reduce"] = jcv.convert_reducing_model
    return mods, params, to_jax


@pytest.mark.parametrize("blend,reduce", [(True, False), (False, True), (True, True)], ids=["blend", "reduce", "both"])
def test_joint_step_loss_and_gradients_match_jax(emb, blend, reduce):
    """``joint_margin_loss`` against ``make_joint_train_step``'s loss."""
    batch = _batch(2, extras=True)
    mods, params, to_jax = _joint_modules(blend, reduce)
    news = torch.from_numpy(emb)
    loss = step.joint_margin_loss(
        mods["tower"], news, tuple(map(torch.from_numpy, batch)), 2.0, mods.get("blend"), mods.get("reduce")
    )
    loss.backward()
    apply = jax_build_tower(_jax_cfg(CFGS["final_attention"])).apply
    blend_apply, reduce_apply = jax_towers.WeightedSumModel().apply, jax_towers.ReducingModel(D, D).apply
    hist_idx, hist_mask, rev, pos, neg, mask, base_p, base_n = map(jnp.asarray, batch)
    table = jnp.asarray(emb)

    def loss_fn(p):
        u = _jax_users(apply, p["tower"], table, hist_idx, hist_mask, reduce_apply if reduce else None, p.get("reduce"))
        u = u[rev]
        cand_p, cand_n = table[pos], table[neg]
        if reduce:
            cand_p, cand_n = reduce_apply(p["reduce"], cand_p), reduce_apply(p["reduce"], cand_n)
        cos_p, cos_n = jax_step.safe_cosine(u, cand_p), jax_step.safe_cosine(u, cand_n)
        if blend:
            cos_p, cos_n = blend_apply(p["blend"], cos_p, base_p), blend_apply(p["blend"], cos_n, base_n)
        return jax_losses.margin_ranking_loss(cos_p, cos_n, 2.0, mask)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    assert abs(loss.item() - float(want_loss)) <= 1e-6
    _assert_grads({k: _grads(m, to_jax[k]) for k, m in mods.items()}, want_grads)


@pytest.mark.parametrize("infonce", [False, True], ids=["margin", "infonce"])
def test_classification_step_loss_and_gradients_match_jax(emb, infonce):
    """The content scorer's losses against ``make_classification_*_step``'s."""
    rng = np.random.default_rng(6)
    params = convert.random_classification_head_params(rng, D, 48)
    head = towers.ClassificationHead(D, 48)
    head.load_state_dict(convert.classification_head_state_dict_from_jax(params))
    _, _, _, pos, neg, mask = _batch(3, infonce)
    news = torch.from_numpy(emb)
    tb = tuple(map(torch.from_numpy, (pos, neg, mask)))
    loss = step.classification_infonce_loss(head, news, tb) if infonce else step.classification_margin_loss(head, news, tb, 2.0)
    loss.backward()
    apply = jax_towers.ClassificationHead(D, 48).apply
    table, jpos, jneg, jmask = jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mask)

    def loss_fn(p):
        pos_scores = apply(p, table[jpos])[:, 0]
        if not infonce:
            return jax_losses.margin_ranking_loss(pos_scores, apply(p, table[jneg])[:, 0], 2.0, jmask)
        neg_scores = apply(p, table[jnp.maximum(jneg, 0).reshape(-1)])[:, 0].reshape(jneg.shape)
        return jax_losses.infonce_loss(pos_scores, neg_scores, (jneg >= 0).astype(jnp.float32), 1.0, jmask)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    assert abs(loss.item() - float(want_loss)) <= 1e-6
    # InfoNCE's softmax is unchanged when every score moves alike: the last
    # bias has no gradient.
    zero = ("['linear_3']['bias']",) if infonce else ()
    _assert_grads(_grads(head, jcv.convert_classification_head), want_grads, zero)


@pytest.mark.parametrize("infonce", [False, True], ids=["margin", "infonce"])
def test_whole_padded_steps_match_jax_step(emb, infonce):
    """Three whole steps of the transformer tower, optimizer included (lr
    1e-5, clip 0.5), against the JAX package's jitted padded step on a new
    batch each step: each loss within 1e-5, the parameters within 2 lr
    after the last (Adam moves a parameter by about lr a step whatever its
    gradient's size)."""
    cfg = TrainConfig()
    tower, params = _tower("transformer")
    opt = make_optimizer(cfg, tower.parameters())
    apply = jax_build_tower(_jax_cfg(CFGS["transformer"])).apply
    jopt = jax_make_optimizer(JaxTrainConfig())
    make = jax_step.make_tower_infonce_step if infonce else jax_step.make_tower_train_step
    jstep = jax.jit(make(apply, jopt, K if infonce else cfg.margin))
    jparams = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jparams)
    news = torch.from_numpy(emb)
    for i in range(3):
        batch = _batch(10 + i, infonce)
        tb = tuple(map(torch.from_numpy, batch))
        loss_t = step.padded_infonce_loss(tower, news, tb) if infonce else step.padded_margin_loss(tower, news, tb, cfg.margin)
        loss = step.apply_step(opt, loss_t)
        jparams, state, jloss = jstep(jparams, state, jnp.asarray(emb), jnp.asarray(emb), *map(jnp.asarray, batch), jax.random.key(i))
        assert abs(loss.item() - float(jloss)) <= 1e-5, i
    got = convert.transformer_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in tower.state_dict().items():
        assert (p - got[name]).abs().max().item() <= 2 * cfg.learning_rate, name


def test_as_built_optimizer_matches_optax(emb):
    """An ``as_built=True`` transformer's attention and MLP parameters are
    inert: the backward leaves their ``.grad`` None. ``ClippedAdamW`` takes
    that as a zero gradient, as optax's chain does for an inert leaf (the
    clip counts it, AdamW's decoupled weight decay still applies), so over 5
    steps on the port's gradients the parameters stay within 1e-6 relative
    of optax's; the inert ones have decayed by (1 - lr * wd)^5."""
    cfg_t = dataclasses.replace(CFGS["transformer"], num_layers=1, as_built=True)
    params = convert.random_transformer_params(np.random.default_rng(8), cfg_t)
    tower = build_tower(cfg_t)
    tower.load_state_dict(convert.transformer_state_dict_from_jax(params))
    init = {n: p.detach().clone() for n, p in tower.named_parameters()}
    cfg = dict(learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=0.5)
    opt = make_optimizer(TrainConfig(**cfg), tower.parameters())
    jopt = jax_make_optimizer(JaxTrainConfig(**cfg))
    jparams = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jparams)
    update = jax.jit(jopt.update)
    news = torch.from_numpy(emb)
    for i in range(5):
        loss = step.padded_margin_loss(tower, news, tuple(map(torch.from_numpy, _batch(20 + i))), 2.0)
        loss.backward()
        assert tower.encoder.layer[0].attention.qkv_proj.weight.grad is None
        grads = _grads(tower, CONVERT["transformer"])
        opt.step()
        opt.zero_grad(set_to_none=True)
        updates, state = update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    got = CONVERT["transformer"]({n: p.detach().numpy() for n, p in tower.named_parameters()})
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=jax.tree_util.keystr(path))
    inert = "encoder.layer.0.attention.qkv_proj.weight"
    decayed = init[inert] * (1 - cfg["learning_rate"] * cfg["weight_decay"]) ** 5
    torch.testing.assert_close(dict(tower.named_parameters())[inert].detach(), decayed, rtol=1e-6, atol=0)
