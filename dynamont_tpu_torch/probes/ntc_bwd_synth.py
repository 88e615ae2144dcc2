"""Probe: the card's K13 variants on seeded synthetic inputs (counterpart of
scripts/probe_ntc_bwd_synth.py, #19).

    python -m dynamont_tpu_torch.probes.ntc_bwd_synth [T_pad] [variant ...] [--device cuda|cpu]

T_pad defaults to 4096, the variants to `prod fwd`; the names are
probes.VARIANTS' and `pv`, which times K15 (ntc_kernels.pv) on the prod
variant's store. The inputs are a bucket of 16 reads at the engine's
geometry (8 n-slots, 128 k-slots, K = 1024) built by synth_inputs. On
the TPU the kernel's cost did not depend on the values; on the card the
gathers' addresses do, so ntc_bwd_variants runs the same variants on
real reads beside these.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from dynamont_tpu_torch.cli._protocol import device_or_exit
from dynamont_tpu_torch.probes import ProbeInputs, min_ms, run_variants

R, CN, CK0, A, K = 16, 8, 120, 4, 1024


def synth_inputs(T_pad: int, K: int, dims, seed: int = 0, dtype=None,
                 device="cpu") -> ProbeInputs:
    """A valid K13 input set of shape dims = (R, CN, CK, A) at T_pad rows,
    from numpy's generator at `seed`: every read at full length (T_r =
    T_pad, N_r = N2 = max(2 CN, T_pad // 8)), random k-mer ids, CN
    consecutive n-slot candidates per row around the diagonal, CK - CN
    distinct TK candidates per row drifting by one every 4 rows, a model
    table of K k-mers (means U(-2, 2), stdevs U(0.15, 0.4)) and a signal of
    each row's diagonal k-mer mean plus noise. The plan comes from
    ops/ntc_batch.build_plan_batch and the parameters from K11's plain
    gather, so the maps, allowed cells, hd and digits are the engine's."""
    import torch

    from dynamont_tpu_torch.constants import NTK_TRANSITIONS
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    dtype = torch.float32 if dtype is None else dtype
    R_, CN_, CK, A_ = dims
    CK0_ = CK - CN_
    rng = np.random.default_rng(seed)
    N2 = max(2 * CN_, T_pad // 8)
    kid = rng.integers(0, K, size=(R_, N2 - 1)).astype(np.int32)
    t = np.arange(T_pad)
    diag = np.round(t * (N2 - 1) / (T_pad - 1)).astype(np.int64)
    c0 = diag[:, None] - CN_ // 2 + rng.integers(-1, 2, size=(T_pad, R_))
    c0 = np.clip(c0, 0, N2 - CN_)
    cand_n = (c0[:, :, None] + np.arange(CN_)).astype(np.int32)
    perm = np.stack([rng.permutation(K) for _ in range(R_)])        # (R, K)
    shift = (t // 4)[:, None, None] + np.arange(CK0_)[None, None, :]
    cand_k = np.take_along_axis(perm[None], shift % K, axis=2).astype(np.int32)
    ids = np.arange(R_)[None, :, None]
    kn1 = kid[ids, np.clip(cand_n - 1, 0, N2 - 2)]
    kn2 = kid[ids, np.clip(cand_n, 0, N2 - 2)]
    means = rng.uniform(-2.0, 2.0, K)
    sd = rng.uniform(0.15, 0.4, K)
    c1 = -0.5 * 1.8378770664093453 - np.log(sd)
    c2 = 0.5 / (sd * sd)
    row_k = kid[np.arange(R_)[None, :], np.clip(diag, 0, N2 - 2)[:, None]]  # (T, R)
    sig = (means[row_k.T[:, :T_pad - 1]]
           + 0.1 * rng.standard_normal((R_, T_pad - 1))).astype(np.float32)

    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    full = lambda v: torch.full((T_pad, R_), v, dtype=torch.int32, device=device)
    N_r = torch.full((R_,), N2, dtype=torch.int32, device=device)
    T_r = torch.full((R_,), T_pad, dtype=torch.int32, device=device)
    plan, pdims = nb.build_plan_batch(put(cand_n), full(CN_), put(cand_k), full(CK0_),
                                      put(kid), N_r, K, A_, round(math.log(K, A_)),
                                      put(kn1), put(kn2))
    if tuple(pdims) != tuple(dims):
        raise ValueError(f"synth_inputs: plan dims {pdims} are not {dims}")
    table = nb.combined_tables(*(put(v) for v in (means, c1, c2)), A_, dtype)
    prm = kern.tab_gather_plain(nb.gather_index(plan), table, pdims)
    trans_log = {k: math.log(v) for k, v in NTK_TRANSITIONS["rna002"].items()}
    return ProbeInputs(plan, pdims, prm, put(sig).to(dtype), trans_log, N_r, T_r)


def run(T_pad: int, variants, device, check=None, log=print) -> dict:
    """The probe on synth_inputs(T_pad, K, (16, 8, 128, 4), seed 0): each
    variant's line (probes.run_variants, `check` seeing its output), and
    for `pv` K15's time on the prod variant's store. Returns {name: ms}."""
    import torch

    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_probe_kernels as pk
    from dynamont_tpu_torch.probes import variant_kwargs

    dims = nb.PlanDims(R, CN, CN + CK0, A)
    inp = synth_inputs(T_pad, K, dims, 0, device=device)
    log(f"T_pad={T_pad} R={R} {tuple(dims)} K={K} fp32 on "
        f"{torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    times = run_variants(inp, [v for v in variants if v != "pv"], device, check, log)
    if "pv" in variants:
        store = pk.bwd_variant(*inp, **variant_kwargs("prod"))
        Zb = nb.ntc_zb_batch(inp.plan, store[0])
        _, ms = min_ms(lambda: kern.pv(inp.plan, inp.dims, inp.prm, inp.sig, store, Zb,
                                       inp.trans_log, inp.T_r), device)
        times["pv"] = ms
        log(f"{'pv':7s} {'K15 on the prod store':38s}: {ms:10.3f} ms "
            f"{ms * 1e3 / T_pad:9.3f} us/column step")
    return times


def main(argv=None) -> int:
    from dynamont_tpu_torch.probes import VARIANTS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("T_pad", nargs="?", type=int, default=4096)
    ap.add_argument("variants", nargs="*", default=["prod", "fwd"],
                    help=f"of {', '.join(VARIANTS)}, pv")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bad = [v for v in args.variants if v not in VARIANTS and v != "pv"]
    if bad:
        ap.error(f"unknown variants {bad}")
    run(args.T_pad, args.variants, device_or_exit(args.device),
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
