"""The content scorer's batch (``utils.memory.estimate_head_batch``) equal
to the JAX package's at explicit budgets, NV-Embed's latent-pool head in
the encoder's envelope, and ``utils.profiling``'s ``timed`` and
``profile_trace`` on the CPU."""

import dataclasses

import json

import pytest
import torch

from news_recommendation_project_v2_tpu.utils import memory as jax_memory
from news_recommendation_project_v2_torch.config import EncoderConfig
from news_recommendation_project_v2_torch.utils import memory
from news_recommendation_project_v2_torch.utils.profiling import profile_trace, timed
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


@pytest.mark.parametrize("budget", [None, 80 * 1024**3, 16 * 1024**3, 1 << 20])
@pytest.mark.parametrize("in_dim,hidden_dim", [(1024, 1024), (1024, 4096), (32, 32)])
@pytest.mark.parametrize("train", [False, True])
def test_estimate_head_batch_matches_jax(budget, in_dim, hidden_dim, train):
    """``None`` is 16 GiB on the CPU in both packages."""
    got = memory.estimate_head_batch(in_dim, hidden_dim, train=train, hbm_budget_bytes=budget)
    want = jax_memory.estimate_head_batch(in_dim, hidden_dim, train=train, hbm_budget_bytes=budget)
    assert got == want and got % 8 == 0 and got >= 8


def test_estimate_head_batch_reads_the_device_budget():
    assert memory.estimate_head_batch(1024, device=torch.device("cpu")) == memory.estimate_head_batch(
        1024, hbm_budget_bytes=memory.DEFAULT_BUDGET_BYTES
    )


NV_EMBED = EncoderConfig(
    vocab_size=32000, hidden_dim=4096, num_layers=32, num_heads=32, intermediate_dim=14336, arch="qwen2",
    num_kv_heads=8, head_dim=128, bidirectional=True, latent_pool=True, param_dtype="bfloat16",
    compute_dtype="bfloat16",
)


@pytest.mark.parametrize("heads,dim_head", [(8, 4096), (4, 4096), (8, 1024), (2, 512)])
def test_the_encoders_envelope_holds_the_latent_pool_head(heads, dim_head):
    """The head's term is in the envelope, in the compute type, and grows by
    two q-wide blocks a token (q and its permuted copy) with heads x
    dim_head; without the head the envelope is the backbone's."""
    cfg = dataclasses.replace(NV_EMBED, latent_pool_heads=heads, latent_pool_dim_head=dim_head)
    plain = dataclasses.replace(cfg, latent_pool=False)
    batch, length = 16, 64
    head = memory.encoder_activation_bytes(cfg, batch, length) - memory.encoder_activation_bytes(plain, batch, length)
    assert head == memory.latent_pool_bytes(cfg, batch, length, 2) > 0
    wider = dataclasses.replace(cfg, latent_pool_dim_head=2 * dim_head)
    grown = memory.latent_pool_bytes(wider, batch, length, 2) - memory.latent_pool_bytes(cfg, batch, length, 2)
    assert grown == batch * length * 2 * heads * dim_head * 2
    assert memory.latent_pool_bytes(plain, batch, length, 2) == 0
    # At these widths the head outweighs the Mistral block a token, so it sets the batch.
    assert head > memory.transformer_activation_bytes(4096, 32, 14336, batch, length, 2)
    budget = 80 * 1024**3
    assert memory.estimate_encoder_batch(cfg, length, budget) < memory.estimate_encoder_batch(plain, length, budget)


def test_timed_records_a_block(capsys):
    sink = []
    with timed("block", sink):
        torch.ones(8).sum()
    assert [label for label, _ in sink] == ["block"] and sink[0][1] >= 0
    with timed("printed"):
        pass
    assert "[timed] printed:" in capsys.readouterr().out


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(tmp_path / "trace") as prof:
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    assert any("mm" in e.key for e in prof.key_averages())
    assert "traceEvents" in json.loads((tmp_path / "trace" / "trace.json").read_text())
