"""Model parameters as device tensors.

The JAX package keeps a pore model as numpy tables (utils/pore_model.py)
and the NT transitions as floats (constants.NT_TRANSITIONS); this turns
them into the tensors the port computes from, so both packages start from
the same numbers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class BandedParams(NamedTuple):
    means: torch.Tensor  # (K,) k-mer level means
    c1: torch.Tensor     # (K,) -0.5*log(2pi) - log(sd)
    c2: torch.Tensor     # (K,) 0.5 / sd^2
    log_m1: float        # log transition probabilities
    log_e2: float


def params_from_numpy(model, m1: float, e2: float, *, device,
                      dtype) -> BandedParams:
    """The float64 numpy tables of `model.score_params()` (a PoreModel),
    cast to `dtype` on `device`, and the log transitions."""
    put = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    means, c1, c2 = model.score_params()
    return BandedParams(put(means), put(c1), put(c2), math.log(m1),
                        math.log(e2))
