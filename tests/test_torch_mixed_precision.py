"""Mixed-precision training in the port against the JAX package, on the CPU:
every train step with ``TowerConfig(compute_dtype=...)`` in bfloat16 and in
float16 (parameters float32, matmuls in the compute type, LayerNorms,
softmaxes and the pool or readout float32), ``ClippedAdamW`` on bfloat16
parameters against optax, and ``TowerTrainer`` on a bfloat16 latent tower
against the JAX trainer. The kernel wrappers compute their plain versions
under their ``autograd.Function``s; the JAX towers run their XLA path.

Batches and weights are the float32 tests' (``test_torch_train_step``,
``test_torch_padded_steps``, ``test_torch_e2e_steps``): numpy-seeded,
loaded through ``convert.*_state_dict_from_jax``, dropout off.

The two frameworks round to the compute type in other places, so the port
is held to "no less accurate than the JAX package, and near it". With
``g32`` the JAX package's float32 gradient of the same step, every leaf
satisfies ``|g_port - g32| <= 1.5 |g_jax - g32| + 5e-3 |g32|`` (norms) and
lies within a norm-relative 0.15 of the JAX package's gradient in the same
compute type; losses within 1e-3 absolute. A leaf whose gradient cancels
(the transformer's ``linear1.bias``: its readout normalises exp(w) over the
history; InfoNCE's last content-scorer bias) is held by absolute norm, under
``ZERO_TOL`` in both packages. final_attention's ReLU sign flips are
handled as the comment at ``RELU`` says.

Measured on the CPU, over every leaf held: losses within 4.5e-4 of JAX's
(bfloat16, the e2e step) and 1.6e-5 (float16); ``|g_port - g32|`` at most
5e-3 |g32| plus 0.94 (bfloat16) and 0.89 (float16) of ``|g_jax - g32|``;
the port within a norm-relative 7.9e-2 (bfloat16, final_attention's
``linear4.bias``) and 4.8e-3 (float16) of JAX's gradient; the cancelling
leaves' norms at most 5.9e-5 in the port and 8.6e-5 in JAX. ReLU sign
flips feed leaves in all six final_attention cases; in one (the joint step
in float16) a fed leaf missed the criteria on the batch and was held with
the flipped tokens masked out.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import test_torch_padded_steps as padded_t
import test_torch_train_step as flat_t
from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.data.compiler import compile_behaviors as jax_compile
from news_recommendation_project_v2_tpu.models import TokenAttentionPool as JaxTokenAttentionPool
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.models import convert_towers as jcv
from news_recommendation_project_v2_tpu.models import towers as jax_towers
from news_recommendation_project_v2_tpu.train import losses as jax_losses
from news_recommendation_project_v2_tpu.train import step as jax_step
from news_recommendation_project_v2_tpu.train import trainer as jax_trainer
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.data.synthetic import align_embeddings, synthetic_learnable_behaviors
from news_recommendation_project_v2_torch.models import TokenAttentionPool, build_tower, convert, towers
from news_recommendation_project_v2_torch.models.layers import dense
from news_recommendation_project_v2_torch.ops.encode import TokenStore
from news_recommendation_project_v2_torch.ops.geglu import geglu_backward
from news_recommendation_project_v2_torch.train import step
from news_recommendation_project_v2_torch.train.trainer import TowerTrainer, make_optimizer
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

DTYPES = ["bfloat16", "float16"]
LOSS_TOL = 1e-3
ZERO_TOL = 2e-4


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(g, np.float64) for p, g in jax.tree_util.tree_leaves_with_path(tree)}


def _run_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled at XLA's backend optimisation level
    0: some forty compiles take half the time, and the level changes only
    the order of float32 sums (the float32 tests, at the default level,
    hold the two packages within 1e-5)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _jax_value_and_grad(loss_fn, params) -> tuple[float, dict]:
    loss, grads = _run_jit(jax.value_and_grad(loss_fn), jax.tree.map(jnp.asarray, params))
    return float(loss), _leaves(grads)


def _hold(port_loss: float, port_grads, jax_low, jax32, zero: tuple = (), lenient: tuple = ()) -> list:
    """The module's criteria: the loss, then every gradient leaf (port and
    JAX trees in the JAX layout, float32 leaves). A leaf named in
    ``lenient`` that misses them is returned instead of failing."""
    (want_loss, low), (_, g32) = jax_low, jax32
    assert abs(port_loss - want_loss) <= LOSS_TOL, (port_loss, want_loss)
    got = _leaves(port_grads)
    assert set(got) == set(low) == set(g32) and got
    missed = []
    for name, g in got.items():
        j, w = low[name], g32[name]
        assert np.isfinite(g).all(), name
        if any(z in name for z in zero):
            assert np.linalg.norm(g) < ZERO_TOL and np.linalg.norm(j) < ZERO_TOL, name
            continue
        err, ref = np.linalg.norm(g - w), np.linalg.norm(j - w)
        ok = err <= 1.5 * ref + 5e-3 * np.linalg.norm(w) and np.linalg.norm(g - j) <= 0.15 * np.linalg.norm(j)
        if not ok and any(z in name for z in lenient):
            missed.append(name)
            continue
        assert err <= 1.5 * ref + 5e-3 * np.linalg.norm(w), (name, err, ref)
        assert np.linalg.norm(g - j) <= 0.15 * np.linalg.norm(j), name
    return missed


def _jax_grads(users_fn, losses: dict, params) -> tuple[dict, dict]:
    """Each loss of ``losses`` (a function of the user vectors) and its
    gradient through ``users_fn`` (params -> (user vectors, aux)), in one
    compile that traces the tower once: ({name: (loss, grads)}, aux)."""

    def both(p):
        users, pull, aux = jax.vjp(users_fn, p, has_aux=True)
        out = {}
        for name, loss_fn in losses.items():
            loss, g_users = jax.value_and_grad(loss_fn)(users)
            out[name] = (loss, pull(g_users)[0])
        return out, aux

    out, aux = _run_jit(both, jax.tree.map(jnp.asarray, params))
    return {n: (float(loss), _leaves(g)) for n, (loss, g) in out.items()}, jax.tree.map(np.asarray, aux)


# The JAX package's results of each case by compute type: the margin and
# InfoNCE steps share their user vectors and one compile, and float32 serves
# both compute types.
_JAX: dict = {}


def _jax_cached(key, compute):
    if key not in _JAX:
        _JAX[key] = compute()
    return _JAX[key]


# 1. The flat margin and InfoNCE steps.


def _pair_losses(news, pairs: dict) -> dict:
    """The JAX package's margin and InfoNCE losses as functions of the user
    vectors, composed as its step factories compose them (``pairs``: name
    to (hist_rev, pos, neg, mask))."""

    def margin(users, hist_rev, pos, neg, mask):
        u = users[hist_rev]
        return jax_losses.margin_ranking_loss(
            jax_step.safe_cosine(u, news[pos]), jax_step.safe_cosine(u, news[neg]), 2.0, mask
        )

    def infonce(users, hist_rev, pos, neg, mask):
        u = users[hist_rev]
        neg_e = news[jnp.maximum(neg, 0)]
        un = jnp.sqrt((u * u).sum(-1, keepdims=True) + 1e-16)
        nn_ = jnp.sqrt((neg_e * neg_e).sum(-1) + 1e-16)
        neg_scores = (u[:, None, :] * neg_e).sum(-1) / (un * nn_)
        pos_scores = jax_step.safe_cosine(u, news[pos])
        return jax_losses.infonce_loss(pos_scores, neg_scores, (neg >= 0).astype(jnp.float32), 1.0, mask)

    fns = {"margin": margin, "infonce": infonce}
    return {
        name: (lambda users, f=fns[name], a=tuple(map(jnp.asarray, args)): f(users, *a))
        for name, args in pairs.items()
    }


LOSSES = {False: "margin", True: "infonce"}


@pytest.fixture(scope="module")
def flat_world():
    rng = np.random.default_rng(0)
    params = convert.random_latent_params(rng, TowerConfig(**flat_t.SMALL))
    batches = {LOSSES[i]: flat_t._batch(1, i) for i in (False, True)}
    assert all(np.array_equal(a, b) for a, b in zip(batches["margin"][:3], batches["infonce"][:3]))
    return dict(params=params, emb=rng.standard_normal((flat_t.NUM_NEWS, 64)).astype(np.float32), batches=batches)


def _jax_flat(world, dtype: str):
    """The JAX flat step's losses (``_flat_user_vectors`` and the pair
    losses, as ``test_torch_train_step._jax_loss_fn`` composes them), its
    tower in ``dtype``."""
    tower = jax_build_tower(JaxTowerConfig(kind="latent", compute_dtype=dtype, **flat_t.SMALL))
    tok_idx, tok_rows, lens = map(jnp.asarray, world["batches"]["margin"][:3])
    news = jnp.asarray(world["emb"])

    def users(p):
        return jax_step._flat_user_vectors(tower.apply, p, news, tok_idx, tok_rows, lens, True, jax.random.key(0)), {}

    losses = _pair_losses(news, {k: b[3:] for k, b in world["batches"].items()})
    return _jax_grads(users, losses, world["params"])[0]


@pytest.mark.parametrize("infonce", [False, True], ids=["margin", "infonce"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_step_matches_jax(flat_world, dtype, infonce):
    batch = flat_world["batches"][LOSSES[infonce]]
    tower = build_tower(TowerConfig(compute_dtype=dtype, **flat_t.SMALL))
    tower.load_state_dict(convert.latent_state_dict_from_jax(flat_world["params"]), strict=True)
    loss = flat_t._port_loss(tower, infonce, flat_world["emb"], batch)
    loss.backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in tower.parameters())
    low, f32 = (_jax_cached(("flat", dt), lambda dt=dt: _jax_flat(flat_world, dt)) for dt in (dtype, "float32"))
    _hold(loss.item(), flat_t._grads_jax_layout(tower), low[LOSSES[infonce]], f32[LOSSES[infonce]])


# 2. The padded margin and InfoNCE steps of every tower.


@pytest.fixture(scope="module")
def padded_emb():
    return np.random.default_rng(0).standard_normal((padded_t.NUM_NEWS, padded_t.D)).astype(np.float32)


# The float32 tests' towers; the transformer at one layer of their two, to
# keep the file's time.
CFGS = {**padded_t.CFGS, "transformer": dataclasses.replace(padded_t.CFGS["transformer"], num_layers=1)}


def _padded_tower(kind: str, dtype: str):
    cfg = dataclasses.replace(CFGS[kind], compute_dtype=dtype)
    params = convert.random_tower_params(np.random.default_rng(1), cfg)
    tower = build_tower(cfg)
    tower.load_state_dict(convert.tower_state_dict_from_jax(kind, params), strict=True)
    return tower, params, cfg


# final_attention's linears whose output goes through a ReLU. Where a ReLU
# input lies within rounding of 0, the compute types round it to one sign in
# one computation and to the other in another: that token's term of the
# linear's gradient, and of every linear and reducer before it, is in one
# gradient and out of the other (a discrete jump, not a rounding). The
# final_attention cases find such tokens among the port's, the JAX package's
# and the float32 computation. Where a leaf that a flip feeds misses the
# criteria, the flipped tokens are masked out of the histories (the tower is
# per token up to its readout, so the other tokens' ReLU inputs do not
# move), no flip may be left, and every leaf is held again.
RELU = (1, 2, 4)


def _capturing(apply, store: list):
    """``apply`` that also keeps final_attention's ReLU inputs, by linear."""

    def wrapped(p, *args, **kwargs):
        y, state = apply(p, *args, capture_intermediates=True, **kwargs)
        store.append({j: state["intermediates"][f"linear{j}"]["__call__"][0] for j in RELU})
        return y

    return wrapped


def _port_relu_inputs(tower, x) -> dict:
    """The port tower's ReLU inputs on its input ``x`` [B, L, D], as its
    forward computes them (dropout off)."""
    cdt = tower.compute_dtype
    with torch.no_grad():
        z1 = dense(tower.linear1, x, cdt)
        z2 = dense(tower.linear2, F.relu(z1), cdt)
        z4 = dense(tower.linear4, dense(tower.linear3, F.relu(z2), cdt), cdt)
    return {j: z.float().numpy() for j, z in zip(RELU, (z1, z2, z4))}


def _flips(hist_mask, *relu_inputs) -> dict:
    """By linear, the real tokens [B, L] whose ReLU inputs take another sign
    in one of the computations than in the first."""
    first, *others = relu_inputs
    return {
        j: np.any([((first[j] > 0) != (z[j] > 0)).any(-1) for z in others], axis=0) & (hist_mask > 0)
        for j in RELU
    }


def _hold_final_attention(name: str, dtype: str, batch: tuple, port_run, jax_run) -> None:
    """``_hold`` for a step through final_attention, its ReLU sign flips
    handled as above. ``port_run(batch)`` gives the port's (loss, grads,
    ReLU inputs); ``jax_run(dtype, hist_mask)`` the JAX package's
    ({loss name: (loss, grads)}, ReLU inputs) on the batch with that history
    mask. batch[1] is the history mask."""
    fed_by = lambda j: (*(f"['linear{i}']" for i in range(1, j + 1)), "['reduce']")  # noqa: E731
    port_loss, port_grads, zp = port_run(batch)
    (low, zl), (f32, z32) = (jax_run(dt, batch[1]) for dt in (dtype, "float32"))
    flips = _flips(batch[1], zp, zl, z32)
    fed = max((j for j in RELU if flips[j].any()), default=0)
    if not _hold(port_loss, port_grads, low[name], f32[name], lenient=fed_by(fed) if fed else ()):
        return
    flipped = np.any(list(flips.values()), axis=0)
    batch = (batch[0], batch[1] * ~flipped) + batch[2:]
    port_loss, port_grads, zp = port_run(batch)
    (low, zl), (f32, z32) = (jax_run(dt, batch[1]) for dt in (dtype, "float32"))
    assert flipped.any() and not np.any(list(_flips(batch[1], zp, zl, z32).values()))
    _hold(port_loss, port_grads, low[name], f32[name])


@pytest.mark.parametrize("infonce", [False, True], ids=["margin", "infonce"])
@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_padded_step_matches_jax(padded_emb, dtype, kind, infonce):
    news = torch.from_numpy(padded_emb)
    batches = {LOSSES[i]: padded_t._batch(1, i) for i in (False, True)}
    assert all(np.array_equal(a, b) for a, b in zip(batches["margin"][:2], batches["infonce"][:2]))
    _, params, cfg = _padded_tower(kind, dtype)
    fa = kind == "final_attention"

    def port_run(batch):
        tower, _, _ = _padded_tower(kind, dtype)
        tb = tuple(map(torch.from_numpy, batch))
        loss = step.padded_infonce_loss(tower, news, tb) if infonce else step.padded_margin_loss(tower, news, tb, 2.0)
        loss.backward()
        grads = padded_t._grads(tower, padded_t.CONVERT[kind])
        return loss.item(), grads, _port_relu_inputs(tower, news[tb[0].long()] * tb[1][..., None]) if fa else None

    def jax_run(dt, hist_mask):
        def compute():
            apply = jax_build_tower(padded_t._jax_cfg(dataclasses.replace(cfg, compute_dtype=dt))).apply
            store: list = []
            apply = _capturing(apply, store) if fa else apply
            table, hist_idx, mask = jnp.asarray(padded_emb), jnp.asarray(batches["margin"][0]), jnp.asarray(hist_mask)

            def users(p):
                return padded_t._jax_users(apply, p, table, hist_idx, mask), store[-1] if fa else {}

            return _jax_grads(users, _pair_losses(table, {k: b[2:] for k, b in batches.items()}), params)

        return _jax_cached(("padded", kind, dt, hist_mask.tobytes()), compute)

    batch = batches[LOSSES[infonce]]
    if fa:
        _hold_final_attention(LOSSES[infonce], dtype, batch, port_run, jax_run)
        return
    port_loss, port_grads, _ = port_run(batch)
    (low, _), (f32, _) = (jax_run(dt, batch[1]) for dt in (dtype, "float32"))
    zero = ("['linear1']['bias']",) if kind == "transformer" else ()
    _hold(port_loss, port_grads, low[LOSSES[infonce]], f32[LOSSES[infonce]], zero)


# 3. The joint step (blend and reducer) and the classification steps.


@pytest.mark.parametrize("dtype", DTYPES)
def test_joint_step_matches_jax(padded_emb, dtype):
    """``joint_margin_loss`` with a blend and a reducer over a
    final_attention tower in ``dtype``; the blend and the reducer have no
    compute type in either package and stay float32."""
    D = padded_t.D
    _, tparams, cfg = _padded_tower("final_attention", dtype)
    rng = np.random.default_rng(4)
    params = {"tower": tparams, "blend": convert.random_weighted_sum_params(rng), "reduce": convert.random_reducing_params(rng, D, D)}
    news = torch.from_numpy(padded_emb)
    batch = padded_t._batch(2, extras=True)

    def port_run(batch):
        tower, _, _ = _padded_tower("final_attention", dtype)
        blend, reduce = towers.WeightedSumModel(), towers.ReducingModel(D, D)
        blend.load_state_dict(convert.weighted_sum_state_dict_from_jax(params["blend"]))
        reduce.load_state_dict(convert.reducing_state_dict_from_jax(params["reduce"]))
        tb = tuple(map(torch.from_numpy, batch))
        loss = step.joint_margin_loss(tower, news, tb, 2.0, blend, reduce)
        loss.backward()
        grads = {
            "tower": padded_t._grads(tower, padded_t.CONVERT["final_attention"]),
            "blend": padded_t._grads(blend, jcv.convert_weighted_sum),
            "reduce": padded_t._grads(reduce, jcv.convert_reducing_model),
        }
        with torch.no_grad():
            x = reduce(news[tb[0].long()]) * tb[1][..., None]
        return loss.item(), grads, _port_relu_inputs(tower, x)

    blend_apply, reduce_apply = jax_towers.WeightedSumModel().apply, jax_towers.ReducingModel(D, D).apply
    table = jnp.asarray(padded_emb)

    def jax_run(dt, hist_mask):
        def compute():
            store: list = []
            apply = _capturing(jax_build_tower(padded_t._jax_cfg(dataclasses.replace(cfg, compute_dtype=dt))).apply, store)
            hist_idx, _, rev, pos, neg, mask, base_p, base_n = map(jnp.asarray, batch)

            def loss_fn(p):
                u = padded_t._jax_users(apply, p["tower"], table, hist_idx, jnp.asarray(hist_mask), reduce_apply, p["reduce"])[rev]
                cand_p, cand_n = reduce_apply(p["reduce"], table[pos]), reduce_apply(p["reduce"], table[neg])
                cos_p = blend_apply(p["blend"], jax_step.safe_cosine(u, cand_p), base_p)
                cos_n = blend_apply(p["blend"], jax_step.safe_cosine(u, cand_n), base_n)
                return jax_losses.margin_ranking_loss(cos_p, cos_n, 2.0, mask), store[-1]

            (loss, z), grads = _run_jit(jax.value_and_grad(loss_fn, has_aux=True), jax.tree.map(jnp.asarray, params))
            return {"margin": (float(loss), _leaves(grads))}, jax.tree.map(np.asarray, z)

        return _jax_cached(("joint", dt, hist_mask.tobytes()), compute)

    _hold_final_attention("margin", dtype, batch, port_run, jax_run)


@pytest.mark.parametrize("infonce", [False, True], ids=["margin", "infonce"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_classification_step_matches_jax(padded_emb, dtype, infonce):
    """The content scorer has no compute type in either package (its three
    ``Dense``/``Linear`` layers take none): under a mixed-precision
    configuration both train it in float32, so here the JAX package's
    gradient in ``dtype`` is its float32 one and the criteria hold the port
    to it within 5e-3 of its norm."""
    rng = np.random.default_rng(6)
    D = padded_t.D
    params = convert.random_classification_head_params(rng, D, 48)
    head = towers.ClassificationHead(D, 48)
    head.load_state_dict(convert.classification_head_state_dict_from_jax(params))
    _, _, _, pos, neg, mask = padded_t._batch(3, infonce)
    news = torch.from_numpy(padded_emb)
    tb = tuple(map(torch.from_numpy, (pos, neg, mask)))
    loss = step.classification_infonce_loss(head, news, tb) if infonce else step.classification_margin_loss(head, news, tb, 2.0)
    loss.backward()
    apply = jax_towers.ClassificationHead(D, 48).apply
    table, jpos, jneg, jmask = jnp.asarray(padded_emb), jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mask)

    def make_loss(dt):
        def loss_fn(p):
            pos_scores = apply(p, table[jpos])[:, 0]
            if not infonce:
                return jax_losses.margin_ranking_loss(pos_scores, apply(p, table[jneg])[:, 0], 2.0, jmask)
            neg_scores = apply(p, table[jnp.maximum(jneg, 0).reshape(-1)])[:, 0].reshape(jneg.shape)
            return jax_losses.infonce_loss(pos_scores, neg_scores, (jneg >= 0).astype(jnp.float32), 1.0, jmask)

        return loss_fn

    jax32 = _jax_cached(("classification", infonce), lambda: _jax_value_and_grad(make_loss("float32"), params))
    # InfoNCE's softmax is unchanged when every score moves alike: the last
    # bias has no gradient.
    zero = ("['linear_3']['bias']",) if infonce else ()
    _hold(loss.item(), padded_t._grads(head, jcv.convert_classification_head), jax32, jax32, zero)


# 4. The e2e margin step on a resident store.

E2E_D, E2E_NEWS, E2E_M, E2E_REAL, E2E_T, E2E_B, E2E_L = 32, 40, 24, 19, 6, 16, 8
E2E_TOWER = dict(kind="latent", reduced_dim=E2E_D, embedding_dim=E2E_D, num_latents=8, num_heads=2, latent_dim_head=16)


@pytest.fixture(scope="module")
def e2e_data():
    """``test_torch_e2e_steps``' store and margin batch on index grids into
    the flat store (the resident route): NEWS items of 1 to 9 tokens, REAL
    of them padded to M rows and T tokens, 7 histories in [B, L] (one all
    pad), 14 real pairs of B."""
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((int(rng.integers(1, 10)), E2E_D)).astype(np.float32) for _ in range(E2E_NEWS)]
    store = TokenStore.from_ragged(arrays)
    uniq = np.sort(rng.choice(E2E_NEWS, E2E_REAL, replace=False))
    store.gather_padded(uniq, max_len=E2E_T)  # the float32 test's draws, in order
    tok_idx, tok_mask = store.padded_index_batch(uniq, E2E_T, out_rows=E2E_M, max_len=E2E_T)
    lens = rng.integers(1, E2E_L + 1, 7)
    lens[3] = 0
    hist_idx = np.zeros((E2E_B, E2E_L), np.int32)
    hist_mask = np.zeros((E2E_B, E2E_L), np.float32)
    for r, n in enumerate(lens):
        hist_idx[r, :n] = rng.integers(0, E2E_REAL, n)
        hist_mask[r, :n] = 1.0
    real = 14
    rev = np.pad(rng.integers(0, 7, real), (0, E2E_B - real)).astype(np.int32)
    rev[:2] = 3
    pos = np.pad(rng.integers(0, E2E_REAL, real), (0, E2E_B - real)).astype(np.int32)
    neg = np.pad(rng.integers(0, E2E_REAL, real), (0, E2E_B - real)).astype(np.int32)
    pair_mask = np.pad(np.ones(real, np.float32), (0, E2E_B - real))
    return dict(flat=store.states, grids=(tok_idx, tok_mask), margin=(hist_idx, hist_mask, rev, pos, neg, pair_mask))


def _jax_e2e_loss(dtype: str, data):
    """``make_end2end_train_step_gathered``'s loss, dropout off, the tower in
    ``dtype`` and ``TokenAttentionPool`` float32 (it takes no compute type)."""
    enc = JaxTokenAttentionPool(hidden_size=E2E_D, num_layers=1)

    def enc_apply(p, s, m, deterministic=False, rngs=None):
        return enc.apply(p, s, m, deterministic=True)

    tower_apply = jax_build_tower(JaxTowerConfig(compute_dtype=dtype, **E2E_TOWER)).apply
    hist_idx, hist_mask, rev, pos, neg, pair_mask = map(jnp.asarray, data["margin"])
    flat = jnp.asarray(data["flat"])
    tok_idx, tok_mask = map(jnp.asarray, data["grids"])

    def loss_fn(p):
        states = flat[tok_idx].astype(jnp.float32) * tok_mask[..., None]
        news_vecs, u = jax_step._e2e_news_and_user(
            enc_apply, tower_apply, p, states, tok_mask, hist_idx, hist_mask, rev, jax.random.key(0)
        )
        return jax_losses.margin_ranking_loss(
            jax_step.safe_cosine(u, news_vecs[pos]), jax_step.safe_cosine(u, news_vecs[neg]), 2.0, pair_mask
        )

    return loss_fn


@pytest.mark.parametrize("dtype", DTYPES)
def test_e2e_step_on_a_resident_store_matches_jax(e2e_data, dtype):
    cfg = TowerConfig(compute_dtype=dtype, **E2E_TOWER)
    params = convert.random_e2e_params(np.random.default_rng(1), E2E_D, 1, cfg)
    model = torch.nn.ModuleDict({"token_encoder": TokenAttentionPool(E2E_D, 1), "tower": build_tower(cfg)})
    model.load_state_dict(convert.e2e_state_dict_from_jax(params), strict=True)
    for layer in model["token_encoder"].encoder.layer:
        layer.dropout_rate = layer.g_mlp.dropout_rate = 0.0
    batch = tuple(map(torch.from_numpy, e2e_data["grids"] + e2e_data["margin"]))
    flat = torch.from_numpy(e2e_data["flat"])
    loss = step.e2e_margin_loss_gathered(model["token_encoder"], model["tower"], flat, batch, 2.0)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    part = lambda prefix: {k[len(prefix):]: v for k, v in grads.items() if k.startswith(prefix)}  # noqa: E731
    got = {
        "token_encoder": jcv.convert_token_attention_pool(part("token_encoder."), num_layers=1),
        "tower": jcv.convert_latent_attention(part("tower.")),
    }
    jax_low, jax32 = (
        _jax_cached(("e2e", dt), lambda dt=dt: _jax_value_and_grad(_jax_e2e_loss(dt, e2e_data), params))
        for dt in (dtype, "float32")
    )
    _hold(loss.item(), got, jax_low, jax32)


# 5. ClippedAdamW on bfloat16 parameters against optax.


def _bf16_unit(size):
    """bfloat16's spacing at ``size`` (8 significant bits)."""
    size = np.asarray(size, np.float64)
    return np.exp2(np.floor(np.log2(np.where(size > 0, size, 1.0))) - 7)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_optimizer_step_on_bfloat16_parameters_matches_optax(max_norm):
    """One step of ``make_optimizer`` on bfloat16 parameters and gradients
    (global norm about 11: the clip active at 0.5, idle at 1e3) against the
    JAX package's optax chain (``clip_by_global_norm``, then ``adamw`` with
    its betas, eps and decay). The moments are bfloat16 on both sides; both
    compute in bfloat16 in other orders. Each parameter lies within one
    bfloat16 unit (the type's spacing at its size, before or after the
    step) of optax's, plus one unit at the step's size (lr: the update is
    rounded too, and decides the result where the parameter is near 0).
    The moments lie within 8 units of their size: with the clip active the
    two round its scale, a global norm in bfloat16, apart.

    The chain is built here with fixed hyperparameters: the JAX package's
    ``make_optimizer`` wraps ``adamw`` in ``inject_hyperparams``, which
    casts b2 = 0.999 to the parameters' bfloat16, where it is 1.0, so the
    second moment stays 0 and its update is NaN (asserted below). The port
    keeps its hyperparameters in Python floats."""
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 6), "b": (6,), "c": (3, 2, 5)}
    bf16 = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    init = {k: bf16(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    grads = {k: bf16(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    cfg = TrainConfig(learning_rate=1e-2, weight_decay=0.01, grad_clip_norm=max_norm)
    params = {k: torch.nn.Parameter(v.clone()) for k, v in init.items()}
    opt = make_optimizer(cfg, params.values())
    for k, p in params.items():
        p.grad = grads[k].clone()
    opt.step()
    to_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    jparams, jgrads = ({k: to_jax(v) for k, v in tree.items()} for tree in (init, grads))
    chain = optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip_norm),
        optax.adamw(cfg.learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=cfg.weight_decay),
    )
    state = chain.init(jparams)
    updates, state = _run_jit(chain.update, jgrads, state, jparams)
    want = optax.apply_updates(jparams, updates)
    adam = state[1][0]
    for k, p in params.items():
        moments = opt.state[p]
        assert p.dtype == moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.bfloat16
        assert want[k].dtype == adam.mu[k].dtype == adam.nu[k].dtype == jnp.bfloat16
        got, ref = p.detach().float().numpy(), np.asarray(want[k], np.float32)
        size = np.maximum(np.maximum(np.abs(got), np.abs(ref)), np.abs(init[k].float().numpy()))
        assert (np.abs(got - ref) <= _bf16_unit(size) + _bf16_unit(cfg.learning_rate)).all(), k
        for got, ref in ((moments["exp_avg"], adam.mu[k]), (moments["exp_avg_sq"], adam.nu[k])):
            got, ref = got.float().numpy(), np.asarray(ref, np.float32)
            assert (np.abs(got - ref) <= 8 * _bf16_unit(np.maximum(np.abs(got), np.abs(ref)))).all(), k
        assert not torch.equal(p.detach(), init[k])
    jopt = jax_trainer.make_optimizer(JaxTrainConfig(**dataclasses.asdict(cfg)))
    updates, _ = _run_jit(jopt.update, jgrads, jopt.init(jparams), jparams)
    assert all(np.isnan(np.asarray(u, np.float32)).all() for u in jax.tree.leaves(updates))


# 6. TowerTrainer with a bfloat16 latent tower against the JAX trainer.

TRAINER_TOWER = dict(kind="latent", reduced_dim=32, num_latents=4, latent_dim_head=8, compute_dtype="bfloat16")
TRAINER_CFG = dict(learning_rate=3e-4, num_epochs=2, batch_size=64, seed=0)
TRAINER_BUCKETS = (32,)


def test_bfloat16_tower_trainer_matches_jax():
    """``test_models.py::test_mixed_precision_training_learns``' data and
    tower (120 rows of the learnable fixture, d=32, 4 latents of 8 heads x
    8, bfloat16 compute, lr 3e-4, batch 64, 2 epochs, val on the train
    rows), from one numpy-seeded set of weights, both trainers on the padded
    route with the one history bucket of 32 that holds every history: each
    epoch's loss within 1e-2 relative and falling, the parameters still
    float32, the val AUC finite and within 0.02 of JAX's."""
    imps, hist, emb = synthetic_learnable_behaviors(num_news=100, num_rows=120, dim=32, noise=0.05)
    c = compile_behaviors(imps, hist).with_history_view()
    jc = jax_compile(imps, hist).with_history_view()
    assert int(c.hist_lens.max()) <= TRAINER_BUCKETS[-1]
    table = align_embeddings(c.news_ids, emb)
    cfg = TowerConfig(**TRAINER_TOWER)
    params = convert.random_latent_params(np.random.default_rng(0), cfg)
    tower = build_tower(cfg)
    tower.load_state_dict(convert.latent_state_dict_from_jax(params))
    port = TowerTrainer(
        tower, c, table, compiled_val=c, news_emb_val=table, cfg=TrainConfig(**TRAINER_CFG),
        buckets=TRAINER_BUCKETS, flat_train=False, flat_eval=False, device="cpu",
    )
    got = port.train()
    jt = jax_trainer.TowerTrainer(
        jax_build_tower(JaxTowerConfig(**TRAINER_TOWER)).apply, jax.tree.map(jnp.asarray, params), jc,
        jnp.asarray(table), compiled_val=jc, news_emb_val=jnp.asarray(table), cfg=JaxTrainConfig(**TRAINER_CFG),
        buckets=TRAINER_BUCKETS,
    )
    want = jt.train()
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [1, 2]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-2), g["epoch"]
    assert got[-1]["loss"] < got[0]["loss"] and want[-1]["loss"] < want[0]["loss"]
    assert all(p.dtype == torch.float32 for p in port.tower.parameters())
    assert np.isfinite(got[-1]["val"]["auc"]) and abs(got[-1]["val"]["auc"] - want[-1]["val"]["auc"]) <= 0.02


# 7. The GEGLU backward multiplies in the compute type.


def test_geglu_backward_multiplies_in_the_compute_type():
    """``geglu_backward`` on bfloat16 inputs: its dx equals a reference
    whose products take bfloat16 operands (the recomputed ``[h | g]``,
    ``du`` and ``dx``; the gate's derivative in float32) to 1e-6, and
    differs from the same arithmetic with float32 operands by more than
    1e-3 of its norm."""
    rng = np.random.default_rng(11)
    c, d, f = 40, 24, 32
    shapes = ((c, d, 1.0), (2 * f, d, d**-0.5), (2 * f, None, 0.02), (d, f, f**-0.5), (d, None, 0.02))
    args = [
        torch.from_numpy((rng.standard_normal([s for s in (a, b) if s]) * sc).astype(np.float32)).bfloat16()
        for a, b, sc in shapes
    ]
    grad = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)).bfloat16().float()
    dx = geglu_backward(*args, grad)[0]
    assert dx.dtype == torch.bfloat16

    def reference(operand):
        x, w_in, b_in, w_out, _ = (operand(t) for t in args)
        hg = torch.nn.functional.linear(x, w_in, b_in).float()
        h, g = hg.chunk(2, dim=-1)
        du = (operand(grad) @ w_out).float()
        gg = g.detach().requires_grad_()
        (d_gate,) = torch.autograd.grad(torch.nn.functional.gelu(gg, approximate="tanh"), gg, du * h)
        d_hg = torch.cat([du * torch.nn.functional.gelu(g, approximate="tanh"), d_gate], dim=-1)
        return (operand(d_hg) @ w_in).float()

    in_bf16 = reference(lambda t: t.bfloat16())
    in_f32 = reference(lambda t: t.float())
    assert (dx.float() - in_bf16).abs().max().item() <= 1e-6
    assert (in_bf16 - in_f32).norm().item() > 1e-3 * in_f32.norm().item()
