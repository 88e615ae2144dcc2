"""Resquiggle mode: the plain NTC reference against the port's exact
per-read path and its batched engine on the CPU at a small size, float64;
a whole run of the resquiggle cell on the CPU comes out correct and
reports its metrics; the control (the engine's float32 path) comes out not
correct; and a run with the timed path broken underneath comes out not
correct, once for each fault this cell can have (one chip: no exchange
between chips to leave out)."""

import json
import os

import numpy as np
import pytest

from conftest import RQ_CELL, ROOT, short_pad_program

from benchmark.harness.main import main
from benchmark.harness.traffic import make_reads
from benchmark.reference import ntc as ref
from benchmark.reference.table import load_table

TABLE = os.path.join(ROOT, "dynamont_tpu_torch", "models_data", "rna002_5mer.npz")


@pytest.fixture(scope="module")
def table():
    return load_table(TABLE, rna=True)


@pytest.fixture(scope="module")
def reads(table):
    return make_reads(table, np.random.default_rng(20261019), mean_dwell=43.0,
                      min_dwell=2, polya_prefix="AAAAAAAAA",
                      lengths=[300, 452, 381])


def _key(segs):
    return [s[:3] + s[4:] for s in segs]


def test_reference_matches_the_engine(table, reads):
    """float64: the same states, borders and polish k-mers as
    NTCBatchEngine, probabilities within 1e-9, Z within 1e-9 relative."""
    import torch

    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.models.registry import load_model_for_pore

    eng = NTCBatchEngine(load_model_for_pore("rna002"), "rna002", device="cpu",
                         dtype=torch.float64, batch_size=16, t_pad_to=64, n_pad_to=16)
    outs = eng.run([BatchItem(s, r) for s, r in reads])
    assert eng.profile["wide_retries"] == eng.profile["exact_retries"] == 0
    for (sig, read), o in zip(reads, outs):
        rung, Zf, Zb, segs = ref.segment_one(sig, read, table, "rna002")
        assert rung == ref.MAIN_CAPS and o.error is None
        assert _key(segs) == _key(o.segments) and len(segs) > 0
        assert max(abs(a[3] - b[3]) for a, b in zip(segs, o.segments)) <= 1e-9
        assert abs(Zf - o.Z) <= 1e-9 * abs(o.Z)


def test_exact_rung_matches_run_ntc(table, reads):
    """The exact rung over the float64 signal against models/ntc.run_ntc,
    the port's exact per-read path."""
    from dynamont_tpu_torch.models.ntc import run_ntc
    from dynamont_tpu_torch.models.registry import load_model_for_pore

    model = load_model_for_pore("rna002")
    sig, read = reads[1]
    want = run_ntc(sig, read, model, "rna002", device="cpu")
    rung, Zf, _, segs = ref._segments(np.asarray(sig, np.float64),
                                      table.kmer_ids(read), table, "rna002", True)
    assert rung == want.caps
    segs = [s[:4] + (ref.int2kmer(s[4], 4, 5, True),) for s in segs]
    assert _key(segs) == _key(want.segments)
    assert max(abs(a[3] - b[3]) for a, b in zip(segs, want.segments)) <= 1e-9
    assert abs(Zf - want.Z) <= 1e-9 * abs(want.Z)


def test_rungs_by_candidate_counts():
    """The main rung where every column fits (8, 120), the wide rung where
    they fit (16, 240), else the exact rung's ladder, cut at (64, 128)."""
    c = lambda *v: np.array(v)
    assert ref.pick_rung(c(1, 8), c(3, 120), False) == (8, 120, False)
    assert ref.pick_rung(c(9, 2), c(3, 5), False) == (16, 240, False)
    assert ref.pick_rung(c(2, 2), c(3, 241), False) is None
    assert ref.pick_rung(c(2, 2), c(3, 20), True) == (16, 32, False)
    assert ref.pick_rung(c(2, 65), c(3, 20), True) == (64, 128, True)


def test_worker_processes_give_the_same_rows(table, reads):
    one = ref.segment(reads[:2], table, "rna002", workers=1)
    two = ref.segment(reads[:2], table, "rna002", workers=2)
    assert one == two and all(rows for _, _, rows in one)


def _run(capsys, root, seed, program_factory=short_pad_program, trace=0):
    rc = main(["--workload", RQ_CELL, "--seed", str(seed), "--seconds", "0.01",
               "--trace", str(trace)], root=root, device="cpu",
              program_factory=program_factory)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_sound_resquiggle_run_is_correct(capsys, rq_root):
    line, err = _run(capsys, rq_root, 2**31 + 7)
    assert line["correct"] is True, line["check"]
    assert line["attempted"] == 2 and line["failed"] == 0
    assert set(line["metrics"]) == {"reads_per_s.resquiggle", "peak_mem_gib", "setup_s"}
    assert line["check"]["border_diff_share"]["value"] == 0.0
    assert '"wide_retries": 0, "exact_retries": 0' in err


def test_traced_resquiggle_run_reports_its_metrics(capsys, rq_root):
    line, _ = _run(capsys, rq_root, 23, trace=1)
    assert line["correct"] is True
    m = line["metrics"]
    assert {"engine.host_self_ms_per_read.resquiggle", "device.idle_share.resquiggle",
            "ntc.escalated_share.resquiggle", "engine.reads_per_bucket.resquiggle",
            "engine.padded_sample_share.resquiggle"} <= set(m)
    assert m["ntc.escalated_share.resquiggle"]["value"] == 0.0
    assert m["engine.reads_per_bucket.resquiggle"]["value"] == 2.0
    # no card in the trace: no kernel time, so no roofline share
    assert "kernels.roofline_share.resquiggle" not in m
    assert not any(k.endswith(".basic") for k in m)


def test_resquiggle_control_is_not_correct(rq_long_root):
    """The engine's float32 path (the CLI's default) fails the float64
    cell's probability limit on two reads of 8,000 samples (1.4e-4 against
    1e-5 on the CPU)."""
    from benchmark.control import control

    res = control(RQ_CELL, 3, root=rq_long_root, device="cpu")
    assert res["dtype"] == "float32" and res["failed"] == 0
    assert res["passes"] is False


class BrokenNTC:
    """The NTC engine with one fault planted where its answers are
    produced."""

    def __init__(self, fault, config, root, device):
        self.p, self.fault = short_pad_program(config, root, device), fault
        self.items, self.dispatch = self.p.items, self.p.dispatch
        self.format, self.counters, self.close = self.p.format, self.p.counters, self.p.close

    def collect(self, handle):
        outs = self.p.collect(handle)
        if self.fault == "half_left_out":
            return outs[: len(outs) // 2]
        for o in outs:
            segs = o.segments
            if self.fault == "answer_altered":  # every border one sample late
                segs = [(s[0], s[1], s[2] + 1) + tuple(s[3:]) for s in segs]
            elif self.fault == "state_unchanged":  # the walk never moves
                segs = segs[-1:]
            elif self.fault == "polish_altered":  # the polish k-mer of the first
                s = segs[0]
                segs = [s[:4] + ("A" * len(s[4]) if s[4] != "A" * len(s[4])
                                 else "C" * len(s[4]),)] + segs[1:]
            o._segments = segs
        return outs


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered",
                                   "state_unchanged", "polish_altered"])
def test_broken_resquiggle_path_is_not_correct(capsys, rq_root, fault):
    line, _ = _run(capsys, rq_root, 9, lambda c, r, d: BrokenNTC(fault, c, r, d))
    assert line["correct"] is False
