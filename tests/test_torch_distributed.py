"""Two-process runs of the port's batch CLIs on the CPU over
torch.distributed's gloo backend (counterpart of tests/test_distributed.py
and tests/test_distributed_train.py): each process a fresh interpreter
running `python -m dynamont_tpu_torch.cli.<cli> --distributed
--device cpu`, the cluster given by DYNAMONT_COORDINATOR /
DYNAMONT_NUM_PROCESSES / DYNAMONT_PROCESS_ID on 127.0.0.1.

* dynamont-resquiggle --mode basic: reads split {0, 2} / {1, 3} into
  out.rank0 / out.rank1, whose rows are the one-process CSV's byte for
  byte.
* dynamont-train --mode basic, fp64: params.csv and the checkpoints of
  rank 0 identical to one process; rank 1 writes nothing.
* An encode failure injected on rank 1 (the JAX Trainer's unguarded
  KeyError) marks that read failed on both ranks and both finish; a rank
  that dies before the exchange ends its peer's run with an error, not a
  hang.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import zstandard as zstd

from dynamont_tpu_torch.models.registry import load_model_for_pore
from dynamont_tpu_torch.utils.synthetic import make_read

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300

# a process of the port: its CLI, with an optional fault injected on rank 1
DRIVER = r"""
import os, sys
from dynamont_tpu_torch.training import trainer
fault = os.environ.get("TEST_FAULT")
if fault and os.environ.get("DYNAMONT_PROCESS_ID") == "1":
    if fault == "encode":
        encode = trainer.Trainer._encode
        seen = []

        def failing(row, result, *a):
            seen.append(1)
            if len(seen) == 1:
                raise KeyError("TTTTT")
            return encode(row, result, *a)

        trainer.Trainer._encode = staticmethod(failing)
    elif fault == "die":
        def dies(self, jobs):
            raise RuntimeError("injected device failure")

        trainer.Trainer._train_batch = dies
cli = sys.argv[1]
if cli == "train":
    from dynamont_tpu_torch.cli import train as mod
else:
    from dynamont_tpu_torch.cli import resquiggle as mod
mod.main(sys.argv[2:])
assert "jax" not in sys.modules, "the port imported jax"
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DYNAMONT_") and k not in ("PYTHONPATH", "TEST_FAULT")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **extra)
    return env


def _run(cli, args, cwd, world=1, **extra):
    """Runs the CLI in `world` processes at once; returns [(rc, stderr)]."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = _env(**extra)
        flags = []
        if world > 1:
            env.update(DYNAMONT_COORDINATOR=f"127.0.0.1:{port}",
                       DYNAMONT_NUM_PROCESSES=str(world), DYNAMONT_PROCESS_ID=str(rank))
            flags = ["--distributed"]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DRIVER, cli, *args, *flags], env=env, cwd=str(cwd),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            p.kill()
    return out


def _tsv(path, n_reads, n_bases):
    model = load_model_for_pore("rna002")
    rows = []
    for seed in range(n_reads):
        sig, read = make_read(model, n_bases=n_bases, seed=seed)
        rows.append(f"read{seed}\tsig{seed}\t" + ",".join(f"{x:.5f}" for x in sig)
                    + f"\t{read[::-1]}")
    path.write_text("\n".join(rows) + "\n")
    return path


def _csv(path):
    with path.open("rb") as f:
        return zstd.ZstdDecompressor().stream_reader(f).read().decode()


def test_two_process_resquiggle_partitions_reads(tmp_path):
    tsv = _tsv(tmp_path / "reads.tsv", 4, 20)
    args = ["--tsv", str(tsv), "--mode", "basic", "-p", "rna002", "--device", "cpu"]
    [(rc, err)] = _run("resquiggle", args + ["-o", str(tmp_path / "one.csv.zst")], tmp_path)
    assert rc == 0, err[-2000:]
    runs = _run("resquiggle", args + ["-o", str(tmp_path / "two.csv.zst")], tmp_path,
                world=2)
    for rc, err in runs:
        assert rc == 0, err[-2000:]
    assert not (tmp_path / "two.csv.zst").exists()
    one = _csv(tmp_path / "one.csv.zst").splitlines()
    ranks = [_csv(tmp_path / f"two.csv.zst.rank{k}").splitlines() for k in range(2)]
    assert ranks[0][0] == ranks[1][0] == one[0]
    by_read = {}
    for k, lines in enumerate(ranks):
        for ln in lines[1:]:
            by_read.setdefault(ln.split(",")[0], (k, []))[1].append(ln)
    assert {r: k for r, (k, _) in by_read.items()} == {
        "read0": 0, "read1": 1, "read2": 0, "read3": 1}
    merged = [ln for r in ("read0", "read1", "read2", "read3") for ln in by_read[r][1]]
    assert "\n".join(merged).encode() == "\n".join(one[1:]).encode()


TRAIN = ["--mode", "basic", "-p", "rna002", "--batch_size", "4", "-q", "0",
         "--precision", "fp64", "--device", "cpu"]


def _files(outdir):
    return {p.name: p.read_bytes() for p in sorted(outdir.iterdir())}


def test_two_process_training_matches_single_process(tmp_path):
    # n_bases=30: at 20 the polyA stub pushes a read over the >=60%
    # single-nucleotide training filter and the batch never fills
    tsv = _tsv(tmp_path / "reads.tsv", 4, 30)
    [(rc, err)] = _run("train", ["--tsv", str(tsv), "-o", str(tmp_path / "one"), *TRAIN],
                       tmp_path)
    assert rc == 0, err[-2000:]
    runs = _run("train", ["--tsv", str(tsv), "-o", str(tmp_path / "two"), *TRAIN],
                tmp_path, world=2)
    for rc, err in runs:
        assert rc == 0, err[-2000:]
    assert "distributed training: process 0 of 2" in runs[0][1]
    assert "distributed training: process 1 of 2" in runs[1][1]
    one, two = _files(tmp_path / "one"), _files(tmp_path / "two")
    assert sorted(one) == ["params.csv", "trained_0_0.model", "trained_0_1.model"]
    assert two == one
    rows = one["params.csv"].decode().splitlines()
    assert len(rows) == 2 and rows[1].split(",")[:3] == ["0", "1", "4"]


def test_encode_failure_marks_read_failed_without_hang(tmp_path):
    tsv = _tsv(tmp_path / "reads.tsv", 4, 30)
    runs = _run("train", ["--tsv", str(tsv), "-o", str(tmp_path / "two"), *TRAIN],
                tmp_path, world=2, TEST_FAULT="encode")
    for rc, err in runs:
        assert rc == 0, err[-2000:]
    assert "read read1: estimates not encoded on process 1: KeyError('TTTTT')" in runs[1][1]
    for _, err in runs:
        assert "No segmentation calculated for read1 in 0: training failed on its process" in err
    rows = (tmp_path / "two" / "params.csv").read_text().splitlines()
    assert rows[1].split(",")[:3] == ["0", "1", "3"]


def test_dead_peer_ends_the_run(tmp_path):
    tsv = _tsv(tmp_path / "reads.tsv", 4, 30)
    runs = _run("train", ["--tsv", str(tsv), "-o", str(tmp_path / "two"), *TRAIN],
                tmp_path, world=2, TEST_FAULT="die")
    assert runs[1][0] != 0 and "injected device failure" in runs[1][1]
    assert runs[0][0] != 0, runs[0][1][-2000:]
    assert "Connection closed by peer" in runs[0][1]
