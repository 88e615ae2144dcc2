"""Fixtures of the benchmark's CPU tests: the repository root on sys.path,
one torch thread, and a small copy of a cell (a root of its own holding
BENCHMARK.json, the configuration and a traffic file of a few short reads,
with the program and the benchmark's readers linked in)."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELL = json.load(_f)["workloads"][0]["name"]
RQ_CELL = "rna002-resquiggle-fp64.ragged"


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHORT = {"law": "lognormal_quantiles", "median": 900, "sigma": 0.3,
         "min": 600, "max": 1400}


def make_small_root(path, pool_reads=8, chunk_reads=4, check_reads=3,
                    lengths=SHORT, cell_name=CELL):
    """A checkout-like root at `path` whose cell `cell_name` runs a few
    reads of `lengths` (a traffic file's signal_length); returns its
    path."""
    root = str(path)
    os.makedirs(os.path.join(root, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "traffic"), exist_ok=True)
    os.symlink(os.path.join(ROOT, "dynamont_tpu_torch"),
               os.path.join(root, "dynamont_tpu_torch"))
    for d in ("metrics", "roofline", "harness"):
        os.symlink(os.path.join(ROOT, "benchmark", d),
                   os.path.join(root, "benchmark", d))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    config["engine"]["chunk_reads"] = chunk_reads
    config["check"]["reads"] = check_reads
    with open(os.path.join(root, cfg["file"]), "w") as f:
        json.dump(config, f)
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    traffic["pool_reads"] = pool_reads
    traffic["signal_length"] = lengths
    with open(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return make_small_root(tmp_path_factory.mktemp("small_cell"))


@pytest.fixture(scope="session")
def long_root(tmp_path_factory):
    """Two reads of 8,000 samples, the traffic's shortest: long enough for
    float32's departure from float64 to show."""
    return make_small_root(tmp_path_factory.mktemp("long_cell"), pool_reads=2,
                           chunk_reads=2, check_reads=2,
                           lengths={"law": "lognormal_quantiles", "median": 8000,
                                    "sigma": 0.5, "min": 8000, "max": 8000})


# resquiggle mode on the CPU: reads of ~300 samples (the NTC engine's plain
# path costs ~10 ms a padded row)
TINY = {"law": "lognormal_quantiles", "median": 330, "sigma": 0.2,
        "min": 260, "max": 420}


@pytest.fixture(scope="session")
def rq_root(tmp_path_factory):
    return make_small_root(tmp_path_factory.mktemp("rq_cell"), pool_reads=4,
                           chunk_reads=2, check_reads=2, lengths=TINY,
                           cell_name=RQ_CELL)


@pytest.fixture(scope="session")
def rq_long_root(tmp_path_factory):
    """Two reads of 8,000 samples in resquiggle mode: long enough for the
    float32 NTC path's departure from float64 to show."""
    return make_small_root(tmp_path_factory.mktemp("rq_long_cell"), pool_reads=2,
                           chunk_reads=2, check_reads=2, cell_name=RQ_CELL,
                           lengths={"law": "lognormal_quantiles", "median": 8000,
                                    "sigma": 0.5, "min": 8000, "max": 8000})


def short_pad_program(config, root, device):
    """The harness's Program with the NTC engine's rows padded to 64 and its
    k-mers to 16 instead of 2048 and 256, so that the CPU's plain path
    stays short; padding changes no output (tests/test_torch_ntc_engine.py
    holds the engine to that)."""
    from benchmark.harness.program import Program

    p = Program(config, root, device)
    p.engine.t_pad_to, p.engine.n_pad_to = 64, 16
    return p
