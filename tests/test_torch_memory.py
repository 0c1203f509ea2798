"""The content scorer's batch (``utils.memory.estimate_head_batch``) equal
to the JAX package's at explicit budgets, and ``utils.profiling``'s
``timed`` and ``profile_trace`` on the CPU."""

import json

import pytest
import torch

from news_recommendation_project_v2_tpu.utils import memory as jax_memory
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
