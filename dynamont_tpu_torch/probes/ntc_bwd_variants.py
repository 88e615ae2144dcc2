"""Probe: the card's K13 variants on the engine's own bucket (counterpart of
scripts/probe_ntc_bwd_variants.py, #20).

    python -m dynamont_tpu_torch.probes.ntc_bwd_variants [T] [--bases N] [--device cuda|cpu]

16 synthetic reads of N bases (default 1800, mean dwell 9, rna002),
trimmed to T samples (default 16000), go through the resquiggle engine's
bucket program at its caps (8, 120): the TN/TK pre-pass (K7-K10), the
selections, the plan and K11 (models/ntc_batch.ntc_bucket_program, whose
keep hands out K13's inputs). Then every variant of probes.VARIANTS runs
on those inputs; C = 16 staged does not fit the card's shared memory and
is reported with its bytes.
"""

from __future__ import annotations

import argparse

from dynamont_tpu_torch.cli._protocol import device_or_exit
from dynamont_tpu_torch.probes import ALL_VARIANTS, ProbeInputs, run_variants

READS = 16


def real_inputs(engine, reads) -> ProbeInputs:
    """K13's inputs for `reads`, (signal, read) pairs, as one bucket of
    `engine` (an NTCBatchEngine) at its caps."""
    from dynamont_tpu_torch.models.batch import BatchItem

    k = {}
    engine._dispatch(list(range(len(reads))), [BatchItem(s, r) for s, r in reads],
                     engine.cap_n, engine.cap_k, keep=k)
    return ProbeInputs(k["plan"], k["dims"], k["prm"], k["sig"], k["trans_log"],
                       k["N_r"], k["T_r"])


def run(T: int, bases: int, device, t_pad_to: int = 2048, check=None,
        log=print) -> dict:
    """The probe on the engine's bucket of READS reads (module docstring):
    each variant's line, `check` seeing its output. Returns {name: ms}."""
    import torch

    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.utils.synthetic import make_read

    model = load_model_for_pore("rna002")
    reads = []
    for s in range(READS):
        sig, read = make_read(model, n_bases=bases, mean_dwell=9.0, seed=s)
        reads.append((sig[:T], read))
    eng = NTCBatchEngine(model, "rna002", device=device, t_pad_to=t_pad_to)
    inp = real_inputs(eng, reads)
    log(f"T_pad={inp.sig.shape[1] + 1} R={READS} {tuple(inp.dims)} fp32 on "
        f"{torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    return run_variants(inp, ALL_VARIANTS, device, check, log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("T", nargs="?", type=int, default=16000)
    ap.add_argument("--bases", type=int, default=1800)
    ap.add_argument("--t-pad-to", type=int, default=2048,
                    help="the engine's T_pad quantum (default its own, 2048)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.T, args.bases, device_or_exit(args.device), args.t_pad_to,
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
