"""The port's plot/segmentation CLI on the CPU: on one short read,
`main --device cpu` hands plot_borders the border rows JAX's main hands
it (borders, bases, motifs and states identical; the fp32 engines'
probabilities within 2e-3, the repo's fp32 bound). The rows are compared,
not the pixels."""

import pytest

from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu.plot import segmentation as jax_seg
from dynamont_tpu_torch.plot import segmentation as torch_seg

from tests.synthetic import make_read


def _rows(mod, monkeypatch, argv):
    got = {}

    def capture(signal, rows, read, readid, outpath, model=None, **kw):
        got.update(rows=rows, read=read, readid=readid, n=len(signal))

    monkeypatch.setattr(mod, "plot_borders", capture)
    mod.main(argv)
    return got


def test_segmentation_main_rows_match_jax(tmp_path, monkeypatch):
    sig, read = make_read(load_model_for_pore("rna002"), n_bases=40, seed=21)
    tsv = tmp_path / "reads.tsv"
    tsv.write_text("r7\ts7\t" + ",".join(f"{x:.5f}" for x in sig) + f"\t{read[::-1]}\n")
    argv = ["--tsv", str(tsv), "--readid", "r7", "-p", "rna002", "-o", str(tmp_path / "p.png")]
    want = _rows(jax_seg, monkeypatch, argv)
    got = _rows(torch_seg, monkeypatch, argv + ["--device", "cpu"])
    assert (got["read"], got["readid"], got["n"]) == (want["read"], want["readid"], want["n"])
    assert len(got["rows"]) == len(want["rows"]) > 20
    for g, w in zip(got["rows"], want["rows"]):
        assert list(g[:6]) == list(w[:6]) and g[7] == w[7]
        assert float(g[6]) == pytest.approx(float(w[6]), abs=2e-3)


def test_segmentation_main_needs_a_card_for_cuda(tmp_path, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        torch_seg.main(["--tsv", str(tmp_path / "none.tsv"), "--readid", "r", "-p",
                        "rna002", "-o", str(tmp_path / "p.png")])
    assert e.value.code == 2 and "no CUDA device" in capsys.readouterr().err
