"""The check that decides `correct`: a whole run on the CPU at a small size
comes out correct; the control (the program's float32 path) comes out not
correct; and a run with the timed path broken underneath comes out not
correct, once for each fault this cell can have. The cell runs on one chip,
so it has no exchange between chips to leave out."""

import json
import os
import subprocess
import sys

import pytest

from conftest import CELL, ROOT

from benchmark.harness.main import main


def _run(capsys, root, seed, program_factory=None, trace=0):
    rc = main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.01",
               "--trace", str(trace)], root=root, device="cpu",
              program_factory=program_factory)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_sound_run_is_correct(capsys, small_root):
    line, err = _run(capsys, small_root, 2**31 + 5)
    assert line["correct"] is True
    assert line["attempted"] == 4 and line["failed"] == 0
    assert list(line)[-1] == "check"
    assert set(line["metrics"]) == {"reads_per_s.basic", "peak_mem_gib", "setup_s"}
    assert line["check"]["border_diff_share"]["value"] == 0.0
    assert err.strip().splitlines()[-1].startswith("check failed_reads 0 limit 0")


def test_traced_run_reports_the_per_layer_metrics(capsys, small_root):
    line, _ = _run(capsys, small_root, 17, trace=1)
    assert line["correct"] is True
    m = line["metrics"]
    assert {"engine.host_ms_per_read.basic", "device.idle_share.basic"} <= set(m)
    # no card in the trace: no kernel time, so no roofline share
    assert "kernels.roofline_share.basic" not in m
    assert line["device"]["window_s"] > 0 and "breakdown" in line


def test_control_is_not_correct(long_root):
    """The program's float32 path fails the float64 cell's limits on reads
    of 8,000 samples (the float64 program passes them on the same reads:
    test_sound_run_is_correct_on_long_reads)."""
    from benchmark.control import control

    res = control(CELL, 3, root=long_root, device="cpu")
    assert res["dtype"] == "float32" and res["passes"] is False


def test_sound_run_is_correct_on_long_reads(capsys, long_root):
    line, _ = _run(capsys, long_root, 3)
    assert line["correct"] is True
    assert line["check"]["border_diff_share"]["value"] == 0.0


class Broken:
    """The program with one fault planted where its answers are produced."""

    def __init__(self, fault, config, root, device):
        from benchmark.harness.program import Program

        self.p, self.fault = Program(config, root, device), fault
        self.items, self.dispatch = self.p.items, self.p.dispatch
        self.format, self.counters, self.close = self.p.format, self.p.counters, self.p.close

    def collect(self, handle):
        outs = self.p.collect(handle)
        if self.fault == "half_left_out":
            return outs[: len(outs) // 2]
        for o in outs:
            starts, med, N, k = o.summaries
            starts = starts.copy()
            if self.fault == "answer_altered":
                starts[starts >= 0] += 1
            elif self.fault == "state_unchanged":  # the walk never moves
                starts[:] = -1
            o.summaries = (starts, med, N, k)
        return outs


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered", "state_unchanged"])
def test_broken_timed_path_is_not_correct(capsys, small_root, fault):
    line, _ = _run(capsys, small_root, 9,
                   lambda c, r, d: Broken(fault, c, r, d))
    assert line["correct"] is False


def test_no_jax_after_a_run(small_root):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from benchmark.harness.main import main\n"
        f"rc = main(['--workload', {CELL!r}, '--seed', '4', '--seconds', '0.01',"
        f" '--trace', '0'], root={small_root!r}, device='cpu')\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'rc': rc, 'tops': tops}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env={**os.environ, "USE_FLAX": "0"})
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0
    assert "dynamont_tpu_torch" in res["tops"]
    assert not {"jax", "jaxlib", "flax", "dynamont_tpu"} & set(res["tops"])


def test_reference_imports_nothing_of_the_program():
    import ast
    import glob

    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("dynamont_tpu_torch", "dynamont_tpu", "jax"), (path, n)
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "import benchmark.reference.banded, benchmark.reference.ntc\n"
            "import benchmark.reference.table\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert "dynamont_tpu" not in out.stdout, out.stdout
