"""Probe: the cost of K13's building blocks on the card (counterpart of
scripts/probe_ntc_microops.py, #21).

    MICRO_ITERS=16384 python -m dynamont_tpu_torch.probes.ntc_microops [--device cuda|cpu]

Each block of ops/ntc_probe_kernels.MICRO_BLOCKS runs MICRO_ITERS times
(default 16384) on one (128, 128) tile, y = body(y, aux) * 0.999, from
micro_inputs' standard normal tiles (the TPU probe's); the line gives us
per iteration. The TPU blocks come first, then the forms the card's K13
uses for the same jobs.
"""

from __future__ import annotations

import argparse
import os

from dynamont_tpu_torch.cli._protocol import device_or_exit
from dynamont_tpu_torch.probes import min_ms


def run(iters: int, device, log=print) -> dict:
    """Each block's line; returns {block: (ms, us per iteration)}."""
    import torch

    from dynamont_tpu_torch.ops import ntc_probe_kernels as pk

    x, aux = (torch.from_numpy(a).to(device) for a in pk.micro_inputs(0))
    log(f"device={torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'} "
        f"iters={iters}")
    out = {}
    for block in pk.MICRO_BLOCKS:
        _, ms = min_ms(lambda: pk.microop(block, x, aux, iters), device)
        out[block] = (ms, ms * 1e3 / max(iters, 1))
        log(f"{block:28s}: {out[block][1]:8.3f} us/iter")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(int(os.environ.get("MICRO_ITERS", 16384)), device_or_exit(args.device),
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
