"""The port's flat-token train step (``train.step``, ``train.losses``,
``train.trainer.make_optimizer``) against the JAX package's on the same
numpy-seeded weights and batches, on the CPU, where the kernel wrappers
compute their plain versions under their ``autograd.Function``s.

Weights go into the port with ``latent_state_dict_from_jax``; the port's
gradients come back to the JAX layout with the JAX package's
``convert_latent_attention``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.config import TrainConfig as JaxTrainConfig
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.models.convert_towers import convert_latent_attention
from news_recommendation_project_v2_tpu.train import losses as jax_losses
from news_recommendation_project_v2_tpu.train import step as jax_step
from news_recommendation_project_v2_tpu.train.trainer import make_optimizer as jax_make_optimizer
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.models import build_tower
from news_recommendation_project_v2_torch.models.convert import (
    latent_state_dict_from_jax,
    random_latent_params,
)
from news_recommendation_project_v2_torch.ops.geglu import geglu, reference_geglu
from news_recommendation_project_v2_torch.ops.latent_attention import latent_attention, reference_attention
from news_recommendation_project_v2_torch.train import losses, step
from news_recommendation_project_v2_torch.train.trainer import make_optimizer

SMALL = dict(reduced_dim=64, embedding_dim=64, num_latents=8, num_heads=2, latent_dim_head=16)
NUM_NEWS, B, U, T, K = 200, 48, 30, 1024, 5


def _batch(seed: int, infonce: bool) -> tuple:
    """A flat batch as ``TowerTrainer._epoch_batches_flat`` builds one, at
    T = 1,024: 30 deduped rows (one of a single token) of up to 39 tokens,
    then pad tokens of row B; 40 pairs and 8 pad pairs; InfoNCE negatives
    with -1 pads in real pairs (one pair with a single real negative)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 40, U)
    lens[3] = 1
    total = int(lens.sum())
    tok_idx = rng.integers(0, NUM_NEWS, T).astype(np.int32)  # pad tokens hold ids too
    tok_rows = np.full(T, B, np.int32)
    tok_rows[:total] = np.repeat(np.arange(U, dtype=np.int32), lens)
    lens_arr = np.zeros(B, np.float32)
    lens_arr[:U] = lens
    real = 40
    hist_rev = np.pad(rng.integers(0, U, real), (0, B - real)).astype(np.int32)
    pos = np.pad(rng.integers(0, NUM_NEWS, real), (0, B - real)).astype(np.int32)
    if infonce:
        neg = rng.integers(0, NUM_NEWS, (B, K)).astype(np.int32)
        neg[rng.random((B, K)) < 0.2] = -1
        neg[5, 1:] = -1
        neg[real:] = -1
    else:
        neg = np.pad(rng.integers(0, NUM_NEWS, real), (0, B - real)).astype(np.int32)
    mask = np.pad(np.ones(real, np.float32), (0, B - real))
    return tok_idx, tok_rows, lens_arr, hist_rev, pos, neg, mask


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    params = random_latent_params(rng, TowerConfig(**SMALL))
    emb = rng.standard_normal((NUM_NEWS, 64)).astype(np.float32)
    return dict(params=params, emb=emb)


def _tower(params):
    tower = build_tower(TowerConfig(**SMALL))
    tower.load_state_dict(latent_state_dict_from_jax(params), strict=True)
    return tower


def _jax_loss_fn(use_fused: bool, infonce: bool, emb, batch, margin=2.0):
    """The JAX package's flat loss, composed from its own pieces
    (``make_tower_train_step_flat`` and ``make_tower_infonce_step_flat``
    without the optimizer)."""
    tower = jax_build_tower(JaxTowerConfig(kind="latent", fused_attention=use_fused, **SMALL))
    tok_idx, tok_rows, lens, hist_rev, pos, neg, mask = map(jnp.asarray, batch)
    news = jnp.asarray(emb)

    def loss_fn(p):
        user = jax_step._flat_user_vectors(
            tower.apply, p, news, tok_idx, tok_rows, lens, True, jax.random.key(0)
        )
        u = user[hist_rev]
        pos_scores = jax_step.safe_cosine(u, news[pos])
        if not infonce:
            return jax_losses.margin_ranking_loss(pos_scores, jax_step.safe_cosine(u, news[neg]), margin, mask)
        neg_valid = (neg >= 0).astype(jnp.float32)
        neg_e = news[jnp.maximum(neg, 0)]
        un = jnp.sqrt((u * u).sum(-1, keepdims=True) + 1e-16)
        nn_ = jnp.sqrt((neg_e * neg_e).sum(-1) + 1e-16)
        neg_scores = (u[:, None, :] * neg_e).sum(-1) / (un * nn_)
        return jax_losses.infonce_loss(pos_scores, neg_scores, neg_valid, 1.0, mask)

    return loss_fn


def _port_loss(tower, infonce, emb, batch):
    args = (tower, torch.from_numpy(emb), tuple(map(torch.from_numpy, batch)))
    return step.flat_infonce_loss(*args) if infonce else step.flat_margin_loss(*args, margin=2.0)


def _grads_jax_layout(tower) -> dict:
    """The port's gradients, by parameter name, in the JAX layout."""
    return convert_latent_attention({n: p.grad.numpy() for n, p in tower.named_parameters()})


def _norm_rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


@pytest.mark.parametrize("use_fused", [False, True], ids=["jax_plain", "jax_pallas"])
@pytest.mark.parametrize("infonce", [False, True], ids=["margin", "infonce"])
def test_loss_and_gradients_match_jax(world, infonce, use_fused):
    """Loss and every parameter's gradient of one flat batch against
    ``jax.value_and_grad`` of the JAX loss, its tower plain or through the
    Pallas kernel (interpret mode) and its custom_vjp. Both compute in
    float32 and sum in other orders: the loss within 1e-6, each gradient
    within a norm-relative 1e-5."""
    batch = _batch(1, infonce)
    tower = _tower(world["params"])
    loss = _port_loss(tower, infonce, world["emb"], batch)
    loss.backward()
    params = jax.tree.map(jnp.asarray, world["params"])
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(use_fused, infonce, world["emb"], batch)
    ))(params)
    assert abs(loss.item() - float(want_loss)) <= 1e-6
    got = jax.tree_util.tree_leaves_with_path(_grads_jax_layout(tower))
    want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    assert len(got) == len(want) == 14
    for path, g in got:
        assert _norm_rel(g, want[path]) <= 1e-5, jax.tree_util.keystr(path)


def _attention_args(rng):
    shapes = ((2, 3, 17, 16), (3, 8, 16), (3, 8, 16))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_() for s in shapes]


def _geglu_args(rng):
    c, d, f = 50, 24, 32
    shapes = ((c, d, 1.0), (2 * f, d, d**-0.5), (2 * f, None, 0.02), (d, f, f**-0.5), (d, None, 0.02))
    return [
        torch.from_numpy((rng.standard_normal([s for s in (a, b) if s]) * sc).astype(np.float32)).requires_grad_()
        for a, b, sc in shapes
    ]


@pytest.mark.parametrize("name", ["latent_attention", "geglu"])
def test_functions_backward_matches_autograd_of_the_plain_version(name):
    """Each wrapper under autograd goes through its ``autograd.Function``;
    the Function's backward (plain ops, the probabilities or ``[h | g]``
    recomputed) against ``torch.autograd`` through the plain version on the
    same inputs. Both are the same float32 arithmetic: a norm-relative 1e-6."""
    rng = np.random.default_rng(5)
    wrapper, plain, args = {
        "latent_attention": (latent_attention, reference_attention, _attention_args(rng)),
        "geglu": (geglu, reference_geglu, _geglu_args(rng)),
    }[name]
    out = wrapper(*args)
    assert type(out.grad_fn).__name__.endswith("FunctionBackward")
    grad = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, args, grad)
    want = torch.autograd.grad(plain(*args), args, grad)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _norm_rel(g, w) <= 1e-6


def test_wrappers_take_no_function_without_autograd():
    """With grad mode off (serving, the eval) the wrappers' Functions
    record no graph."""
    rng = np.random.default_rng(6)
    with torch.no_grad():
        assert latent_attention(*_attention_args(rng)).grad_fn is None
        assert geglu(*_geglu_args(rng)).grad_fn is None


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax_chain(max_norm):
    """``make_optimizer`` against the JAX package's optax chain (global-norm
    clip, then AdamW with decay on every parameter) over one sequence of 5
    gradients, of global norm about 11: the clip active at 0.5 and idle at
    1e3. Parameters within 1e-6 relative (float32 rounding of the same
    updates)."""
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 6), "b": (6,), "c": (3, 2, 5)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]
    cfg = dict(learning_rate=1e-3, weight_decay=0.01, grad_clip_norm=max_norm)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_optimizer(TrainConfig(**cfg), params.values())
    jopt = jax_make_optimizer(JaxTrainConfig(**cfg))
    jparams = jax.tree.map(jnp.asarray, init)
    state = jopt.init(jparams)
    update = jax.jit(jopt.update)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        updates, state = update(jax.tree.map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in grads[0].values()))
    assert norm > 5 * max_norm or max_norm > 100 * norm
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("infonce", [False, True], ids=["margin", "infonce"])
def test_steps_match_jax_step(world, infonce, steps):
    """Whole steps, optimizer included (the default lr 1e-5, clip 0.5),
    against the JAX package's jitted flat step on a new batch each step:
    each step's loss within 1e-5, and the parameters within 2 lr of the
    JAX step's after the last (Adam moves a parameter by about lr a step
    whatever its gradient's size, so sums taken in other orders can move a
    near-zero gradient's parameter by up to 2 lr)."""
    cfg = TrainConfig()
    tower = _tower(world["params"])
    opt = make_optimizer(cfg, tower.parameters())
    jtower = jax_build_tower(JaxTowerConfig(kind="latent", **SMALL))
    jopt = jax_make_optimizer(JaxTrainConfig())
    make = jax_step.make_tower_infonce_step_flat if infonce else jax_step.make_tower_train_step_flat
    jstep = jax.jit(make(jtower.apply, jopt, K if infonce else cfg.margin))
    jparams = jax.tree.map(jnp.asarray, world["params"])
    state = jopt.init(jparams)
    news = torch.from_numpy(world["emb"])
    for i in range(steps):
        batch = _batch(10 + i, infonce)
        tb = tuple(map(torch.from_numpy, batch))
        if infonce:
            loss = step.flat_infonce_step(tower, opt, news, tb)
        else:
            loss = step.flat_margin_step(tower, opt, news, tb, cfg.margin)
        jparams, state, jloss = jstep(
            jparams, state, jnp.asarray(world["emb"]), jnp.asarray(world["emb"]),
            *map(jnp.asarray, batch), jax.random.key(i),
        )
        assert abs(loss.item() - float(jloss)) <= 1e-5, i
    got = latent_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in tower.state_dict().items():
        diff = (p - got[name]).abs().max().item()
        assert diff <= 2 * cfg.learning_rate, (name, diff)
    assert max((p - got[n]).abs().max().item() for n, p in tower.state_dict().items()) > 0 or steps == 1


def test_pads_change_nothing(world):
    """Pad tokens (rows of B), pad pairs (mask 0) and -1 negatives carry no
    weight: giving them other ids leaves the loss and every gradient the
    same to the bit."""
    batch = _batch(3, infonce=True)
    other = [a.copy() for a in batch]
    total = int(batch[2].sum())
    other[0][total:] = (other[0][total:] + 17) % NUM_NEWS
    other[3][40:] = 7
    other[4][40:] = 9
    results = []
    for b in (batch, tuple(other)):
        tower = _tower(world["params"])
        loss = _port_loss(tower, True, world["emb"], b)
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in tower.parameters()]))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))


def test_infonce_masks_pad_negatives():
    """A -1 negative takes the type's finite minimum as its logit bias: the
    loss equals the cross-entropy over the real negatives alone, and a row
    whose negatives are all pad has loss 0 and finite gradients."""
    rng = np.random.default_rng(8)
    pos = torch.from_numpy(rng.standard_normal(4).astype(np.float32)).requires_grad_()
    neg = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)).requires_grad_()
    valid = torch.tensor([[1, 1, 1], [1, 0, 1], [0, 0, 0], [1, 0, 0]], dtype=torch.float32)
    got = losses.infonce_loss(pos, neg, valid, temperature=0.5)
    rows = []
    for i in range(4):
        logits = torch.cat([pos[i : i + 1], neg[i][valid[i] > 0]]) / 0.5
        rows.append(-torch.log_softmax(logits, 0)[0])
    torch.testing.assert_close(got, torch.stack(rows).mean(), rtol=0, atol=1e-6)
    assert rows[2].item() == 0.0
    got.backward()
    assert torch.isfinite(neg.grad).all() and torch.isfinite(pos.grad).all()
    want = jax_losses.infonce_loss(
        jnp.asarray(pos.detach().numpy()), jnp.asarray(neg.detach().numpy()), jnp.asarray(valid.numpy()), 0.5
    )
    assert abs(got.item() - float(want)) <= 1e-6


def test_margin_loss_matches_jax():
    """Masked and unmasked, within 1e-6 (float32 sums in other orders)."""
    rng = np.random.default_rng(9)
    pos, neg = (rng.uniform(-1, 1, 6).astype(np.float32) for _ in range(2))
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    for m in (None, mask):
        got = losses.margin_ranking_loss(
            torch.from_numpy(pos), torch.from_numpy(neg), 2.0, None if m is None else torch.from_numpy(m)
        )
        want = jax_losses.margin_ranking_loss(
            jnp.asarray(pos), jnp.asarray(neg), 2.0, None if m is None else jnp.asarray(m)
        )
        assert abs(got.item() - float(want)) <= 1e-6


def test_gather_rows_backward_sums_in_order():
    """``gather_rows``' backward equals the indexing backward (up to the
    order of its sums), rows gathered by no pair included."""
    rng = np.random.default_rng(10)
    src = torch.from_numpy(rng.standard_normal((6, 4))).requires_grad_()
    index = torch.tensor([3, 0, 3, 3, 5, 0, 3])
    grad = torch.from_numpy(rng.standard_normal((7, 4)))
    (got,) = torch.autograd.grad(step.gather_rows(src, index), src, grad)
    (want,) = torch.autograd.grad(src[index], src, grad)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert got[1].abs().sum() == 0


def test_flat_inputs_copy_matches_train_profile():
    """``chip_smoke.flat_inputs`` (phase 7's timed batch) is
    ``benchmarks/train_profile.py``'s, draw for draw."""
    import importlib.util
    from pathlib import Path

    from benchmarks.train_profile import flat_inputs

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for b in (64, 2048):
        T, total, got = smoke.flat_inputs(b, np.random.default_rng(0))
        want = flat_inputs(b, np.random.default_rng(0))
        assert (T, total) == want[:2] and len(got) == len(want[2]) == 7
        for g, w in zip(got, want[2]):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
    assert T == 65_536
