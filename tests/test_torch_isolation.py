"""The port stands alone: it imports nothing of dynamont_tpu or JAX, and its
copies of the JAX-free host code equal the JAX package's.

* An ast scan of every module of dynamont_tpu_torch/ and of chip_smoke.py
  finds no import of dynamont_tpu (or of its modules) and none of jax.
* A fresh interpreter imports every port module and runs the per-read NTC
  CLI on a short read with --device cpu; afterwards neither dynamont_tpu
  nor jax is in sys.modules.
* The copied constants, the three model tables and the copied modules'
  sources (up to the import prefix) equal the JAX package's.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import dynamont_tpu.constants as jax_constants
import dynamont_tpu_torch.constants as torch_constants

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dynamont_tpu_torch"
COPIED = ("constants.py", "utils/kmer.py", "utils/pore_model.py",
          "utils/signal.py", "utils/synthetic.py", "utils/output.py",
          "ops/geometry.py", "models/packing.py", "models/registry.py",
          "io/__init__.py", "io/readers.py", "io/fast5.py", "io/output.py",
          "native.py", "_native/native.cpp",
          "eval/__init__.py", "eval/collect_metrics.py", "eval/compare_tools.py",
          "eval/converters.py", "eval/downstream.py", "eval/edge_detection.py",
          "eval/evaluate_reads.py", "eval/figures.py", "eval/paper_figures.py",
          "plot/__init__.py", "plot/readers.py", "plot/tool_segments.py",
          "plot/trained_params.py")
MODELS = ("rna002_5mer.npz", "rna004_5mer.npz", "trained_rna002_5mer.npz")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("dynamont_tpu", "jax", "jaxlib")]
    assert not bad, bad


def test_port_runs_without_jax_package(tmp_path):
    """Every port module and the per-read NTC CLI in a fresh interpreter."""
    code = """
import importlib, io, pkgutil, sys
import dynamont_tpu_torch
for m in pkgutil.walk_packages(dynamont_tpu_torch.__path__, "dynamont_tpu_torch."):
    importlib.import_module(m.name)
from dynamont_tpu_torch.cli import ntc_main
from dynamont_tpu_torch.models.registry import get_model_path, load_model_for_pore
from dynamont_tpu_torch.utils.synthetic import make_read, signal_to_text
sig, read = make_read(load_model_for_pore("rna002"), n_bases=20, seed=3)
sys.stdin = io.StringIO(f"{signal_to_text(sig)}\\n{read}\\n")
res = ntc_main.main(["-m", get_model_path("rna002"), "-r", "rna002", "--device", "cpu"])
assert res.segments
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("dynamont_tpu", "jax", "jaxlib"))
print("LOADED", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]


def _jax_path(rel: str) -> Path:
    return ROOT / "dynamont_tpu" / rel


@pytest.mark.parametrize("what", ["constants"] + [f"models_data/{m}" for m in MODELS]
                         + [f"source/{c}" for c in COPIED])
def test_copies_equal_jax_package(what):
    if what == "constants":
        names = [n for n in dir(jax_constants)
                 if n.isupper() or n in ("is_rna", "resolve_transitions")]
        assert len(names) > 10
        for n in names:
            a, b = getattr(jax_constants, n), getattr(torch_constants, n)
            if callable(a):
                assert a.__code__.co_code == b.__code__.co_code, n
            else:
                assert a == b, n
        return
    if what.startswith("models_data/"):
        with np.load(_jax_path(what)) as a, np.load(PORT / what) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        return
    rel = what.split("/", 1)[1]
    want = _jax_path(rel).read_text()
    got = (PORT / rel).read_text().replace("dynamont_tpu_torch", "dynamont_tpu")
    assert got == want
