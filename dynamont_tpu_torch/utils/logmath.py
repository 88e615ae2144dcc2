"""Log-space numeric helpers (counterpart of dynamont_tpu/utils/logmath.py).

The JAX module's logaddexp has no counterpart here: torch.logaddexp already
returns -inf for (-inf, -inf), as jnp.logaddexp does."""

from __future__ import annotations

import torch

LOG_2PI = 1.8378770664093453


def log_normal_pdf(x, mean, stdev):
    """log N(x; mean, stdev^2), formulated exactly as the reference
    (ref: utils.hpp:198-215): -0.5*(log2pi + 2*log(s) + ((x-m)/s)^2)."""
    s_inv = 1.0 / stdev
    diff = (x - mean) * s_inv
    return -0.5 * (LOG_2PI + 2.0 * torch.log(stdev) + diff * diff)


def log_normal_pdf_c(x, mean, c1, c2):
    """log N with precomputed c1 = -0.5*log2pi - log(s), c2 = 0.5/s^2,
    rounded as (c2*d)*d like the JAX code writes it."""
    diff = x - mean
    return c1 - c2 * diff * diff


def logsumexp(a, dim=None, keepdim: bool = False):
    """-inf-safe logsumexp in the JAX module's direct form: the max, then
    log(sum(exp(a - max))) + max; an all--inf slice gives -inf."""
    if dim is None:
        a, dim = a.reshape(-1), 0
    amax = torch.amax(a, dim=dim, keepdim=True)
    fin = torch.isfinite(amax)
    amax_safe = torch.where(fin, amax, torch.zeros_like(amax))
    out = torch.log(torch.sum(torch.exp(a - amax_safe), dim=dim,
                              keepdim=True)) + amax_safe
    out = torch.where(fin, out, amax)
    return out if keepdim else out.squeeze(dim)
