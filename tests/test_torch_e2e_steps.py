"""The port's end-to-end train steps (``train.step``: ``e2e_margin_loss``,
``e2e_infonce_loss`` and their ``_gathered`` forms over a store resident on
the device) against the JAX package's (``make_end2end_train_step``,
``make_end2end_infonce_step`` and their ``_gathered`` forms, composed from
its ``_e2e_news_and_user`` and ``_infonce_from_vecs`` as those factories
compose them, without the optimizer), on the CPU, with dropout off, on one
numpy-seeded ``{"token_encoder", "tower"}`` set of weights and batch.

The batch has pad rows past the batch's distinct news, ``-1``-padded
negatives and an all-pad history row that pairs use. The port's gradients
come back to the JAX layout through the JAX package's converters. Both
compute in float32 and sum in other orders: losses within 1e-6, each
gradient within a norm-relative 1e-5 (as the padded steps' tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.config import TowerConfig as JaxTowerConfig
from news_recommendation_project_v2_tpu.models import TokenAttentionPool as JaxTokenAttentionPool
from news_recommendation_project_v2_tpu.models import build_tower as jax_build_tower
from news_recommendation_project_v2_tpu.models import convert_towers as jcv
from news_recommendation_project_v2_tpu.train import losses as jax_losses
from news_recommendation_project_v2_tpu.train import step as jax_step
from news_recommendation_project_v2_torch.config import TowerConfig, TrainConfig
from news_recommendation_project_v2_torch.models import TokenAttentionPool, build_tower, convert
from news_recommendation_project_v2_torch.ops.encode import TokenStore
from news_recommendation_project_v2_torch.train import step
from news_recommendation_project_v2_torch.train.trainer import make_optimizer
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D, NEWS, M, REAL, T, B, L, K = 32, 40, 24, 19, 6, 16, 8, 3
TOWER = dict(kind="latent", reduced_dim=D, embedding_dim=D, num_latents=8, num_heads=2, latent_dim_head=16)


def no_dropout(encoder: TokenAttentionPool) -> TokenAttentionPool:
    """Dropout off on the instance: every layer's rate set to 0."""
    for layer in encoder.encoder.layer:
        layer.dropout_rate = layer.g_mlp.dropout_rate = 0.0
    return encoder


def _model(seed: int = 1):
    params = convert.random_e2e_params(np.random.default_rng(seed), D, 1, TowerConfig(**TOWER))
    model = torch.nn.ModuleDict({"token_encoder": TokenAttentionPool(D, 1), "tower": build_tower(TowerConfig(**TOWER))})
    model.load_state_dict(convert.e2e_state_dict_from_jax(params), strict=True)
    no_dropout(model["token_encoder"])
    return model, params


@pytest.fixture(scope="module")
def data():
    """A store of NEWS items of 1 to 9 tokens; a batch over REAL of them,
    padded to M rows and T tokens both ways (streamed block, index grids);
    U = 7 histories in [B, L] (one all pad, rows past U pad), 14 real pairs
    of B, InfoNCE negatives with -1 pads."""
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((int(rng.integers(1, 10)), D)).astype(np.float32) for _ in range(NEWS)]
    store = TokenStore.from_ragged(arrays)
    uniq = np.sort(rng.choice(NEWS, REAL, replace=False))
    states, mask = store.gather_padded(uniq, max_len=T)
    states = np.pad(states, ((0, M - REAL), (0, T - states.shape[1]), (0, 0)))
    mask = np.pad(mask, ((0, M - REAL), (0, T - mask.shape[1])))
    mask[REAL:, 0] = 1.0
    tok_idx, tok_mask = store.padded_index_batch(uniq, T, out_rows=M, max_len=T)
    assert np.array_equal(tok_mask, mask)
    U, real = 7, 14
    lens = rng.integers(1, L + 1, U)
    lens[3] = 0  # an all-pad history
    hist_idx = np.zeros((B, L), np.int32)
    hist_mask = np.zeros((B, L), np.float32)
    for r, n in enumerate(lens):
        hist_idx[r, :n] = rng.integers(0, REAL, n)
        hist_mask[r, :n] = 1.0
    rev = np.pad(rng.integers(0, U, real), (0, B - real)).astype(np.int32)
    rev[:2] = 3
    pos = np.pad(rng.integers(0, REAL, real), (0, B - real)).astype(np.int32)
    neg = np.pad(rng.integers(0, REAL, real), (0, B - real)).astype(np.int32)
    negs = rng.integers(0, REAL, (B, K)).astype(np.int32)
    negs[rng.random((B, K)) < 0.3] = -1
    negs[real:] = -1
    pair_mask = np.pad(np.ones(real, np.float32), (0, B - real))
    tail = (hist_idx, hist_mask, rev, pos)
    return dict(
        flat=store.states, streamed=(states, mask), gathered=(tok_idx, tok_mask),
        margin=tail + (neg, pair_mask), infonce=tail + (negs, pair_mask),
    )


def _jax_loss(infonce: bool, gathered: bool, data):
    """The JAX step's loss as a function of ``{"token_encoder", "tower"}``,
    dropout off: the encoder's apply is called deterministic."""
    enc = JaxTokenAttentionPool(hidden_size=D, num_layers=1)

    def enc_apply(p, s, m, deterministic=False, rngs=None):
        return enc.apply(p, s, m, deterministic=True)

    tower_apply = jax_build_tower(JaxTowerConfig(**TOWER)).apply
    hist_idx, hist_mask, rev, pos, neg, pair_mask = map(jnp.asarray, data["infonce" if infonce else "margin"])
    flat = jnp.asarray(data["flat"])
    front = tuple(map(jnp.asarray, data["gathered" if gathered else "streamed"]))

    def loss_fn(p):
        states, mask = front
        if gathered:
            states = flat[states].astype(jnp.float32) * mask[..., None]
        news_vecs, u = jax_step._e2e_news_and_user(
            enc_apply, tower_apply, p, states, mask, hist_idx, hist_mask, rev, jax.random.key(0)
        )
        if infonce:
            return jax_step._infonce_from_vecs(u, news_vecs, pos, neg, pair_mask, 1.0)
        return jax_losses.margin_ranking_loss(
            jax_step.safe_cosine(u, news_vecs[pos]), jax_step.safe_cosine(u, news_vecs[neg]), 2.0, pair_mask
        )

    return loss_fn


def _port_loss(model, infonce: bool, gathered: bool, data, generator=None):
    batch = tuple(map(torch.from_numpy, data["gathered" if gathered else "streamed"] + data["infonce" if infonce else "margin"]))
    enc, tower = model["token_encoder"], model["tower"]
    if gathered:
        flat = torch.from_numpy(data["flat"])
        if infonce:
            return step.e2e_infonce_loss_gathered(enc, tower, flat, batch, generator)
        return step.e2e_margin_loss_gathered(enc, tower, flat, batch, 2.0, generator)
    if infonce:
        return step.e2e_infonce_loss(enc, tower, batch, generator)
    return step.e2e_margin_loss(enc, tower, batch, 2.0, generator)


def _norm_rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / max(np.linalg.norm(want), 1e-30))


def _grads_in_jax_layout(model) -> dict:
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    part = lambda prefix: {k[len(prefix):]: v for k, v in grads.items() if k.startswith(prefix)}  # noqa: E731
    return {
        "token_encoder": jcv.convert_token_attention_pool(part("token_encoder."), num_layers=1),
        "tower": jcv.convert_latent_attention(part("tower.")),
    }


@pytest.mark.parametrize("gathered", [False, True], ids=["streamed", "gathered"])
@pytest.mark.parametrize("infonce", [False, True], ids=["margin", "infonce"])
def test_e2e_step_loss_and_gradients_match_jax(data, infonce, gathered):
    model, params = _model()
    loss = _port_loss(model, infonce, gathered, data, torch.Generator().manual_seed(0))
    loss.backward()
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss(infonce, gathered, data)))(
        jax.tree.map(jnp.asarray, params)
    )
    assert abs(loss.item() - float(want_loss)) <= 1e-6
    got = jax.tree_util.tree_leaves_with_path(_grads_in_jax_layout(model))
    want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    assert len(got) == len(want) == 25
    for path, g in got:
        assert _norm_rel(g, want[path]) <= 1e-5, jax.tree_util.keystr(path)
    # The gradient reaches the encoder: every one of its leaves moves.
    assert all(np.abs(v).max() > 0 for v in jax.tree.leaves(_grads_in_jax_layout(model)["token_encoder"]))


@pytest.mark.parametrize("infonce", [False, True], ids=["margin", "infonce"])
def test_streamed_and_gathered_steps_are_identical_with_dropout(data, infonce):
    """Three optimizer steps with dropout on (rate 0.1, one generator
    seeded alike): the streamed and gathered forms give the same bits."""
    finals = []
    for gathered in (False, True):
        params = convert.random_e2e_params(np.random.default_rng(1), D, 1, TowerConfig(**TOWER))
        model = torch.nn.ModuleDict({"token_encoder": TokenAttentionPool(D, 1), "tower": build_tower(TowerConfig(**TOWER))})
        model.load_state_dict(convert.e2e_state_dict_from_jax(params))
        opt = make_optimizer(TrainConfig(learning_rate=1e-3), model.parameters())
        gen = torch.Generator().manual_seed(3)
        losses = [step.apply_step(opt, _port_loss(model, infonce, gathered, data, gen)).item() for _ in range(3)]
        finals.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert finals[0][0] == finals[1][0]
    assert all(torch.equal(a, b) for a, b in zip(finals[0][1], finals[1][1]))


def test_gathered_step_reads_a_float16_store_without_gradient(data):
    """A float16 flat store stays float16; the gather casts it, and no
    gradient reaches it."""
    model, _ = _model()
    flat16 = torch.from_numpy(data["flat"].astype(np.float16))
    batch = tuple(map(torch.from_numpy, data["gathered"] + data["margin"]))
    loss = step.e2e_margin_loss_gathered(model["token_encoder"], model["tower"], flat16, batch, 2.0)
    loss.backward()
    assert flat16.dtype == torch.float16 and flat16.grad is None and np.isfinite(loss.item())
    block = step.gathered_token_states(flat16, batch[0], batch[1])
    want = data["flat"].astype(np.float16).astype(np.float32)[batch[0].numpy()] * batch[1].numpy()[..., None]
    assert block.dtype == torch.float32 and np.array_equal(block.numpy(), want)


def test_e2e_params_from_state_dict_matches_jax_converters():
    """The port's forward converter equals the JAX package's
    ``convert_token_attention_pool`` and ``convert_latent_attention``, and
    inverts ``e2e_state_dict_from_jax`` exactly."""
    model, params = _model(seed=4)
    sd = model.state_dict()
    got = convert.e2e_params_from_state_dict(sd)
    part = lambda prefix: {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}  # noqa: E731
    want = {
        "token_encoder": jcv.convert_token_attention_pool(part("token_encoder."), num_layers=1),
        "tower": jcv.convert_latent_attention(part("tower.")),
    }
    for tree in (want, params):
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)))
