"""No module of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the port either (top-level names compared
whole: the port's name begins with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from portbench.tests.tiny import ROOT

JAX = ["jax", "jaxlib", "flax", "news_recommendation_project_v2_tpu"]
PORT = "news_recommendation_project_v2_torch"


def _loaded_after(modules: list[str], files: list[str] = ()) -> set:
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from portbench.spec import load_module\n"
        f"for f in {list(files)!r}: load_module(__import__('pathlib').Path(f))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def _modules(folder: str) -> list[str]:
    base = ROOT / "portbench"
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (base / folder).rglob("*.py")
        if "tests" not in p.parts and "." not in p.stem
    )


def test_no_benchmark_module_loads_jax_or_the_jax_package():
    modules = _modules(".") + ["portbench.drivers.train", "portbench.drivers.eval"]
    readers = [str(p) for p in (ROOT / "portbench" / "metrics").glob("*.py")]
    per_layer = json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
    assert {Path(r).stem for r in readers} >= {m["name"] for m in per_layer}
    loaded = _loaded_after(modules, readers)
    assert not loaded & set(JAX)


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(_modules("reference"))
    assert not loaded & set(JAX + [PORT])


def test_a_run_imports_the_port_but_not_jax():
    """A whole tiny run on the CPU, in its own process."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path; import tempfile\n"
        "from portbench.tests import tiny\n"
        "from portbench import harness\n"
        "root = tiny.make_root(Path(tempfile.mkdtemp()))\n"
        "r = harness.run_cell(root, 'tiny-latent.eval', 3, 0.2, False, time.perf_counter(), device='cpu')\n"
        "assert r['correct']\n"
        "print(harness.forbidden_modules(), 'news_recommendation_project_v2_torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.splitlines()[-1] == "[] True"
