"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points never quietly fall back to the CPU."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import news_recommendation_project_v2_torch as port
from news_recommendation_project_v2_torch.cli.serve import build_ranker
from news_recommendation_project_v2_torch.config import TowerConfig
from news_recommendation_project_v2_torch.data.compiler import compile_behaviors
from news_recommendation_project_v2_torch.eval.device_metrics import DeviceMetricsPlan
from news_recommendation_project_v2_torch.models import average_pool, build_tower
from news_recommendation_project_v2_torch.ops.scoring import FlatEvalPlan
from news_recommendation_project_v2_torch.serve import Ranker
from news_recommendation_project_v2_torch.train.trainer import TowerTrainer
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = ROOT / "news_recommendation_project_v2_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "news_recommendation_project_v2_tpu"}


def _port_sources():
    return sorted(PORT_DIR.rglob("*.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_importing_the_port_loads_no_jax():
    modules = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 25


def test_every_kernel_source_ships_with_the_package():
    srcs = {p.stem for p in (PORT_DIR / "ops" / "csrc").glob("*.cu")}
    assert srcs == {"latent_attention", "geglu", "moe_experts", "kda"}
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert "ops/csrc/*.cu" in pyproject and "nrtorch-serve" in pyproject


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    emb = np.eye(4, 8, dtype=np.float32)
    ids = [f"N{i}" for i in range(4)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Ranker(average_pool, emb, ids)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.resolve_device(None)
    np.save(tmp_path / "dev.npy", emb)
    np.save(tmp_path / "dev_ids.npy", np.array(ids))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_ranker(tmp_path, "dev")
    assert Ranker(average_pool, emb, ids, device="cpu").device.type == "cpu"
    flat = ([0, 1, 2], [2, 1], [3, 0], [0, 1])  # hist_rev, hist_lens, cand_rev, cand_row
    metric = ([1, 1], [1.0, 0.0])  # imp_lens, labels
    for entry in (FlatEvalPlan, DeviceMetricsPlan):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(*(flat if entry is FlatEvalPlan else metric))
    assert FlatEvalPlan(*flat, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="single label class"):
        DeviceMetricsPlan(*metric, device="cpu")  # checked after the device
    assert DeviceMetricsPlan([2], [1.0, 0.0], device="cpu").device.type == "cpu"
    c = compile_behaviors(["N1-1 N2-0"], ["N3 N1"]).with_history_view()
    tower = build_tower(TowerConfig(reduced_dim=8, num_latents=2, num_heads=1, latent_dim_head=8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TowerTrainer(tower, c, np.eye(3, 8, dtype=np.float32))
    trainer = TowerTrainer(tower, c, np.eye(3, 8, dtype=np.float32), device="cpu")
    assert trainer.device.type == "cpu" and next(trainer.tower.parameters()).device.type == "cpu"
