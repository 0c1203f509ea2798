"""The operation and byte counts against hand counts at one shape."""

from __future__ import annotations

import pytest

from portbench import work
from portbench.reference import latent, transformer

# D = 4, hidden 8, 2 heads of 3 over 5 latents; float32.
LATENT = {"reduced_dim": 4, "hidden_dim": 8, "num_heads": 2, "latent_dim_head": 3, "num_latents": 5,
          "compute_dtype": "float32"}


def test_latent_attention_work_by_hand():
    # 10 tokens in 2 launches: q.k and p.v over 5 latents, 2 heads of 3, each
    # a multiply and an add: 2 * 2 * (10 * 2 * 5 * 3) = 1,200 operations.
    ops, nbytes = work.latent_attention_work(LATENT, 10, 2)
    assert ops == 1200
    # q read and o written a token (2 * 2 * 3 floats), k and v a launch (2 * 2 * 5 * 3).
    assert nbytes == (10 * 2 * 2 * 3 + 2 * 2 * 2 * 5 * 3) * 4


def test_geglu_work_by_hand():
    # 10 tokens: W_in is [16, 4] (2 * 4 * 16 = 128 a token), W_out [4, 8] (64): 192 a token.
    ops, nbytes = work.geglu_work(LATENT, 10, 1)
    assert ops == 1920
    # x in float32 (40 floats), the weights and biases once (64 + 16 + 32 + 4), y out (40 floats).
    assert nbytes == (40 + 64 + 16 + 32 + 4) * 4 + 40 * 4


def test_latent_forward_flops_by_hand():
    # A token: to_q 2*4*6 = 48, to_out 48, logits and p.v 2 * (2*5*6) = 120,
    # GEGLU 128 + 64 = 192: 408. A call: to_kv over 5 latents, 2*5*4*12 = 480.
    assert latent.forward_flops(LATENT, 10, 0.0, 2) == 10 * 408 + 2 * 480


def test_transformer_forward_flops_by_hand():
    tower = {"reduced_dim": 4, "num_layers": 1}
    i = transformer.INTERMEDIATE
    per_token = 2 * 4 * 12 + 2 * 4 * 4 + 2 * 4 * 2 * i + 2 * i * 4 + 2 * 4 * 4
    # Rows of 3 and 2 real tokens: 9 + 4 query-key pairs, 4 * D each (logits and the weighted sum).
    assert transformer.forward_flops(tower, 5, 13.0) == 5 * per_token + 4 * 4 * 13


def test_shares():
    peak = work.PEAKS["flops_per_s"]["float32"]
    assert work.peak_share(peak, 1.0, "float32") == pytest.approx(100.0)
    # Bytes bound: 3.35e9 bytes take 1 ms; a kernel of 2 ms is at half its roofline.
    assert work.roofline_share(1.0, work.PEAKS["bytes_per_s"] * 1e-3, 2e-3, "float32") == pytest.approx(50.0)
    assert work.roofline_share(1.0, 1.0, 0.0, "float32") is None
    assert work.peak_share(0.0, 1.0, "float32") is None
