"""Log-space numeric helpers (counterpart of dynamont_tpu/utils/logmath.py).

The JAX module's logaddexp has no counterpart here: torch.logaddexp already
returns -inf for (-inf, -inf), as jnp.logaddexp does."""

from __future__ import annotations


def log_normal_pdf_c(x, mean, c1, c2):
    """log N with precomputed c1 = -0.5*log2pi - log(s), c2 = 0.5/s^2,
    rounded as (c2*d)*d like the JAX code writes it."""
    diff = x - mean
    return c1 - c2 * diff * diff
