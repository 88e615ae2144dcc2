"""The port's dynamont-resquiggle --mode basic against dynamont_tpu's, on
the same TSV: columns 0-7 and 9 byte-identical, probabilities within 2e-3
(the fp32-against-fp64 bound of tests/test_device_pipeline.py; the two
runs are fp32 engines of different frameworks)."""

import numpy as np
import pytest
import zstandard as zstd

from dynamont_tpu.cli import resquiggle as jax_cli
from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu_torch.cli import resquiggle as torch_cli

from tests.synthetic import make_read


def _write_tsv(path, items):
    with open(path, "w") as f:
        for rid, sig, read in items:
            f.write(f"{rid}\t{rid}\t{','.join(repr(float(x)) for x in sig)}"
                    f"\t{read}\n")


def _rows(path):
    with open(path, "rb") as f:
        data = zstd.ZstdDecompressor().stream_reader(
            f, read_across_frames=True).read()
    lines = data.decode().strip().split("\n")
    return lines[0], [ln.split(",") for ln in lines[1:]]


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    model = load_model_for_pore("rna002")
    items = []
    for s in range(3):
        sig, read_proc = make_read(model, n_bases=40 + 10 * s, seed=140 + s)
        items.append((f"read{s}", sig, read_proc[9:][::-1]))  # 5'->3' RNA
    path = tmp_path_factory.mktemp("cli") / "reads.tsv"
    _write_tsv(path, items)
    return path


def test_port_cli_matches_jax_cli(tsv, tmp_path):
    out_j = tmp_path / "jax.csv.zst"
    out_t = tmp_path / "torch.csv.zst"
    args = ["--tsv", str(tsv), "--mode", "basic", "-p", "rna002"]
    jax_cli.main(args + ["-o", str(out_j)])
    torch_cli.main(args + ["-o", str(out_t), "--device", "cpu"])
    head_j, rows_j = _rows(out_j)
    head_t, rows_t = _rows(out_t)
    assert head_t == head_j
    assert len(rows_t) == len(rows_j) > 0
    assert {r[0] for r in rows_t} == {"read0", "read1", "read2"}
    keep = [0, 1, 2, 3, 4, 5, 6, 7, 9]
    for rt, rj in zip(rows_t, rows_j):
        assert [rt[i] for i in keep] == [rj[i] for i in keep]
    diff = np.abs(np.array([float(r[8]) for r in rows_t])
                  - np.array([float(r[8]) for r in rows_j]))
    assert diff.max() <= 2e-3, diff.max()
    assert not (tmp_path / "jax.errors").exists()
    assert not (tmp_path / "torch.errors").exists()


def test_port_cli_refuses_native_9mer(tsv, tmp_path, capsys):
    """Resquiggle mode at native 9-mer K is not ported yet."""
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["--tsv", str(tsv), "-o", str(tmp_path / "o.csv.zst"),
                        "--mode", "resquiggle", "-p", "rna002",
                        "--ntc-native-9mer"])
    assert e.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not (tmp_path / "o.csv.zst").exists()


def test_port_cli_without_cuda_fails(tsv, tmp_path, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["--tsv", str(tsv), "-o", str(tmp_path / "o.csv.zst"),
                        "--mode", "basic", "-p", "rna002"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o.csv.zst").exists()
