"""The port's exact per-read NTC (models/ntc.run_ntc, cli/ntc_main) against
dynamont_tpu's, on the CPU in fp64.

Each JAX oracle runs once, through dynamont_tpu's own dynamont-NTC CLI in
process, in a module-scoped fixture: it gives both the stdout to hold the
port's CLI to byte for byte and, by a wrapper around run_ntc, the result
to hold run_ntc to (borders and polish k-mers identical, probabilities
within 1e-9, Z within rel 1e-12, trained transitions and emissions within
rel 1e-9). The CAP_LADDER rung JAX reached is recorded by wrapping its
pre-pass. Seed 1 climbs to the third rung.
"""

import contextlib
import io
import sys

import pytest
import torch

from dynamont_tpu.cli import ntc_main as jax_cli
from dynamont_tpu.models import ntc as jax_ntc
from dynamont_tpu.models.registry import get_model_path, load_model_for_pore
from dynamont_tpu.ops import ntc_pre as jax_pre
from dynamont_tpu_torch.cli import ntc_main as torch_cli
from dynamont_tpu_torch.models.ntc import CAP_LADDER

from tests.synthetic import make_read, signal_to_text

FLAGS = {"segment": [], "calcZ": ["-z"], "train": ["--train"]}
RUNS = [(0, "segment"), (0, "calcZ"), (0, "train"), (1, "segment")]


def _stdin(seed):
    model = load_model_for_pore("rna002")
    sig, read = make_read(model, n_bases=25, seed=seed)
    return f"{signal_to_text(sig)}\n{read}\n"


def _call(main, argv, stdin_text, mp):
    out = io.StringIO()
    mp.setattr(sys, "stdin", io.StringIO(stdin_text))
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue()


@pytest.fixture(scope="module")
def jax_runs():
    """(seed, mode) -> (JAX NTCResult, CLI stdout, caps of the last rung)."""
    out = {}
    args = ["-m", get_model_path("rna002"), "-r", "rna002"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNAMONT_NO_COMPILE_CACHE", "1")
        seen, caps = [], []
        run = jax_ntc.run_ntc
        mp.setattr(jax_ntc, "run_ntc",
                   lambda *a, **k: seen.append(run(*a, **k)) or seen[-1])
        for name in ("pre_tn", "pre_tk"):
            f = getattr(jax_pre, name)
            mp.setattr(jax_pre, name, lambda *a, _f=f, **k:
                       caps.append(a[-1]) or _f(*a, **k))
        for seed, mode in RUNS:
            caps.clear()
            _, text = _call(jax_cli.main, args + FLAGS[mode], _stdin(seed), mp)
            out[seed, mode] = (seen[-1], text, tuple(caps[-2:]))
    return out


@pytest.fixture(scope="module")
def torch_runs():
    """(seed, mode) -> (port NTCResult, CLI stdout), --device cpu."""
    out = {}
    args = ["-m", get_model_path("rna002"), "-r", "rna002", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        for seed, mode in RUNS:
            out[seed, mode] = _call(torch_cli.main, args + FLAGS[mode],
                                    _stdin(seed), mp)
    return out


def _close(got, want, rel):
    assert abs(got - want) <= rel * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_matches_jax(jax_runs, torch_runs, seed):
    want = jax_runs[seed, "segment"][0]
    got = torch_runs[seed, "segment"][0]
    _close(got.Z, want.Z, 1e-12)
    assert len(got.segments) == len(want.segments) > 0
    for g, w in zip(got.segments, want.segments):
        assert g[:3] == w[:3] and g[4] == w[4]
        assert abs(g[3] - w[3]) <= 1e-9


def test_calcz_matches_jax(jax_runs, torch_runs):
    _close(torch_runs[0, "calcZ"][0].Z, jax_runs[0, "calcZ"][0].Z, 1e-12)


def test_train_matches_jax(jax_runs, torch_runs):
    want = jax_runs[0, "train"][0]
    got = torch_runs[0, "train"][0]
    _close(got.Z, want.Z, 1e-12)
    assert list(got.trained_transitions) == list(want.trained_transitions)
    for k, v in want.trained_transitions.items():
        _close(got.trained_transitions[k], v, 1e-9)
    assert list(got.trained_emissions) == list(want.trained_emissions)
    for kmer, (m, s) in want.trained_emissions.items():
        _close(got.trained_emissions[kmer][0], m, 1e-9)
        _close(got.trained_emissions[kmer][1], s, 1e-9)


def test_cap_ladder_climb_matches_jax(jax_runs, torch_runs):
    """Seed 1 overflows the first two rungs in both packages and runs at
    the third; the selection is redone per rung from one pair of lattices."""
    assert jax_runs[1, "segment"][2] == CAP_LADDER[2]
    assert torch_runs[1, "segment"][0].caps == CAP_LADDER[2]
    assert torch_runs[0, "segment"][0].caps == jax_runs[0, "segment"][2]


@pytest.mark.parametrize("mode", ["segment", "calcZ", "train"])
def test_cli_stdout_matches_jax(jax_runs, torch_runs, mode):
    assert torch_runs[0, mode][1] == jax_runs[0, mode][1]


def test_cli_cuda_without_card_exits(monkeypatch, capsys):
    """--device cuda without a card fails loudly with a code outside the
    protocol's 1-11, named in --help."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "stdin", io.StringIO(_stdin(0)))
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["-m", get_model_path("rna002"), "-r", "rna002"])
    assert e.value.code == torch_cli.NO_CUDA_EXIT
    assert e.value.code not in range(1, 12)
    assert "no CUDA device" in capsys.readouterr().err
    assert f"{torch_cli.NO_CUDA_EXIT} --device cuda" in \
        torch_cli.build_parser().format_help().replace("\n", " ")


@pytest.mark.parametrize("case,code", [("no_signal", 4), ("no_read", 5),
                                       ("bad_model", 7), ("short_read", 11)])
def test_cli_input_errors_keep_protocol_codes(monkeypatch, case, code):
    text = {"no_signal": "\nACGTACGT\n", "no_read": "1.0,2.0\n\n",
            "bad_model": _stdin(0), "short_read": ",".join(["1.0"] * 10) + "\nACG\n"}[case]
    model = "/nonexistent.model" if case == "bad_model" else get_model_path("rna002")
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["-m", model, "-r", "rna002", "--device", "cpu"])
    assert e.value.code == code
