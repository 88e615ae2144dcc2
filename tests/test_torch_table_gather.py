"""The stacked table gather (#12: ops/ntc_kernels.table_gather, its plain
version on the CPU) against JAX's table_gather_pallas in interpret mode,
bit for bit: JAX's three-way bf16 split recombines every float32 table
value exactly, and the gather does no arithmetic. ks (8, 512) at K = 1024
with the sentinels K and -1 mixed in; combined_tablesT against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu.ops import ntc_pallas as npk
from dynamont_tpu_torch.ops import ntc_batch as nb
from dynamont_tpu_torch.ops import ntc_kernels as nk


@pytest.fixture(scope="module")
def tables():
    model = load_model_for_pore("rna002")
    mu, c1, c2 = model.score_params()
    K = len(mu)
    want = npk.combined_tablesT(*(jnp.asarray(x) for x in (mu, c1, c2)), 4, K)
    got = nb.combined_tablesT(*(torch.from_numpy(x) for x in (mu, c1, c2)), 4)
    return np.asarray(want), got


def test_combined_tablesT_matches_jax(tables):
    want, got = tables
    assert got.dtype == torch.float32 and got.shape == (nb.TG_ROWS, 1024)
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_gather_matches_pallas_kernel(tables):
    want_tab, tabT = tables
    K = tabT.shape[1]
    rng = np.random.default_rng(12)
    ks = rng.integers(0, K, size=(8, 512)).astype(np.int32)
    dead = rng.random(ks.shape)
    ks[dead < 0.1] = K   # the dead-slot sentinel
    ks[dead > 0.95] = -1
    nk.reset_counts()
    got = nk.table_gather(torch.from_numpy(ks), tabT)
    assert nk.PLAIN_RUNS["ntc_table_gather"] == 1
    want = np.asarray(npk.table_gather_pallas(jnp.asarray(ks),
                                              jnp.asarray(want_tab),
                                              interpret=True))
    assert got.shape == (8, nb.TG_ROWS, 512) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    dead_cols = got.numpy().transpose(0, 2, 1)[(ks == K) | (ks < 0)]
    assert dead_cols.shape[0] > 0 and not dead_cols.any()
