"""Forward/backward consistency check (the JAX-free part of
dynamont_tpu/ops/nt_full.py; the full-lattice DP is not ported yet)."""

from __future__ import annotations

import math

from dynamont_tpu.constants import EPSILON


def check_z(Zf, Zb, n_cells) -> bool:
    """Forward/backward consistency invariant (ref: NT_main.cpp:146)."""
    Zf = float(Zf)
    Zb = float(Zb)
    if math.isinf(Zf) or math.isinf(Zb):
        return False
    return abs(Zf - Zb) / n_cells <= EPSILON
