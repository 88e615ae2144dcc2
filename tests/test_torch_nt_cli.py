"""The port's single-read CLIs dynamont-NT (cli/nt_main.py, full lattice)
and dynamont-NT-banded (cli/nt_banded_main.py) against the JAX package's,
in process, --device cpu (fp64), on one short read: stdout byte-identical
in segment, -z and --train mode; the -p line of the same length with every
value within 1e-9 (the band widths differ, so a row's sum may run in
another order); the input-validation exit codes equal."""

import contextlib
import io
import sys

import pytest
import torch

from dynamont_tpu.cli import nt_banded_main as jax_nt_banded
from dynamont_tpu.cli import nt_main as jax_nt
from dynamont_tpu.models.registry import get_model_path, load_model_for_pore
from dynamont_tpu_torch.cli import nt_banded_main as torch_nt_banded
from dynamont_tpu_torch.cli import nt_main as torch_nt
from dynamont_tpu_torch.cli._protocol import NO_CUDA_EXIT

from tests.synthetic import make_read

CLIS = {"NT": (jax_nt.main, torch_nt.main),
        "NT-banded": (jax_nt_banded.main, torch_nt_banded.main)}
MODES = {"segment": [], "calcZ": ["-z"], "train": ["--train"], "prob": ["-p"]}
MODEL = get_model_path("rna002")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, args, stdin: str):
    """(exit code, stdout) of main(args) with `stdin` as standard input."""
    out = io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(stdin)
    code = 0
    try:
        with contextlib.redirect_stdout(out):
            main(args)
    except SystemExit as e:
        code = e.code
    finally:
        sys.stdin = old
    return code, out.getvalue()


@pytest.fixture(scope="module")
def stdin():
    sig, read = make_read(load_model_for_pore("rna002"), n_bases=30, seed=5)
    return ",".join(repr(float(x)) for x in sig) + "\n" + read + "\n"


@pytest.fixture(scope="module")
def outputs(stdin):
    """Every CLI in every mode, once per package: {(cli, mode): (jax, torch)}."""
    base = ["-m", MODEL, "-r", "rna002"]
    return {(cli, mode): (_run(jmain, base + flags, stdin),
                          _run(tmain, base + flags + ["--device", "cpu"], stdin))
            for cli, (jmain, tmain) in CLIS.items()
            for mode, flags in MODES.items()}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cli", list(CLIS))
def test_stdout_matches_jax_cli(outputs, stdin, cli, mode):
    (jcode, want), (tcode, got) = outputs[cli, mode]
    assert jcode == tcode == 0
    if mode != "prob":
        assert got == want
        return
    seg_g, prob_g = got.splitlines()
    seg_w, prob_w = want.splitlines()
    assert seg_g == seg_w
    vals_g = [float(v) for v in prob_g.split(",")[:-1]]
    vals_w = [float(v) for v in prob_w.split(",")[:-1]]
    T = len(stdin.split("\n")[0].split(",")) + 1  # one value per row t
    assert len(vals_g) == len(vals_w) == T
    assert vals_g == pytest.approx(vals_w, abs=1e-9)


BAD_INPUTS = {  # case: (stdin or None for the read's, model or None, exit)
    "signal missing": ("\n", None, 4),
    "read missing": ("1.0,2.0\n\n", None, 5),
    "model path": (None, "/nonexistent/model.npz", 7),
    "signal shorter than read": ("0.1,0.2,0.3\nACGTACGTAC\n", None, 10),
    "read shorter than k": (",".join(["0.1"] * 20) + "\nACG\n", None, 11),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
@pytest.mark.parametrize("cli", list(CLIS))
def test_input_errors_exit_as_jax_cli(cli, case, stdin):
    text, model, code = BAD_INPUTS[case]
    args = ["-m", model or MODEL, "-r", "rna002"]
    jmain, tmain = CLIS[cli]
    jcode, _ = _run(jmain, args, text or stdin)
    tcode, _ = _run(tmain, args + ["--device", "cpu"], text or stdin)
    assert tcode == jcode == code


@pytest.mark.parametrize("cli", list(CLIS))
def test_cuda_without_a_card_exits(cli, stdin, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out = _run(CLIS[cli][1], ["-m", MODEL, "-r", "rna002"], stdin)
    assert code == NO_CUDA_EXIT and out == ""
