"""The checkpointed route's cluster instances (K14 and K15's checkpoint
mode on a thread block cluster of G CTAs a read) on the CPU: which
instance each shape takes, and the fp32 column normalization's order.

The kernels run only on a card (tests/test_torch_cuda_kernels.py holds
them bit for bit against their plain versions there). Here:
  - bwd_ckpt_instance / pv_ckpt_instance at the engine's rungs, caps
    (8, 120), (16, 240) and native big K's (16, 256), in fp32 and fp64,
    each cluster instance's shared memory within one CTA's 232448 bytes;
  - cluster_column_sum, a reference written from csrc/ntc_lattice.cu's
    pv_ckpt_cluster_kernel (each CTA's virtual threads and warp sums over
    its slice of k-slots, then the tree over every CTA's warp sums),
    held bit for bit against the plain version's _tree_sum on seeded
    wide columns, columns that are all -inf and columns full of ties.
"""

import numpy as np
import pytest
import torch

from dynamont_tpu_torch.ops import ntc_batch as nb
from dynamont_tpu_torch.ops import ntc_kernels as kern
from dynamont_tpu_torch.ops.ntc_pre_kernels import _halve, _tree_sum, threads

SMEM_LIMIT = 232448  # shared memory one CTA of an H100 may take

# (cap_n, cap_k) -> (CN, CK): the main rung, the wide rung, native big K's
RUNGS = {(8, 120): (8, 128), (16, 240): (16, 256), (16, 256): (16, 272)}
# (CK, itemsize) -> (K14's, K15's checkpoint mode's) (instance, G)
WANT = {
    (128, 4): (("cluster", 8), ("cluster", 4)),
    (128, 8): (("cluster", 8), ("cluster", 8)),
    (256, 4): (("cluster", 8), ("cluster", 8)),
    (256, 8): (("cluster", 8), ("cluster", 16)),
    (272, 4): (("cluster", 8), ("device", 1)),  # CK 272 does not divide B = 256
    (272, 8): (("cluster", 8), ("cluster", 16)),
}


@pytest.mark.parametrize("caps", list(RUNGS))
@pytest.mark.parametrize("itemsize", [4, 8])
def test_ckpt_instances_by_shape(caps, itemsize):
    CN, CK = RUNGS[caps]
    got = [kern.bwd_ckpt_instance(CN, CK, 4, itemsize),
           kern.pv_ckpt_instance(CN, CK, 4, itemsize)]
    assert [(i.name, i.G) for i in got] == list(WANT[CK, itemsize])
    for inst, size in zip(got, (kern.bwd_ckpt_cluster_bytes,
                                lambda CN, KS, A, isz: kern.pv_ckpt_cluster_bytes(
                                    CN, KS, A, isz, nb.C_CKPT))):
        if inst.name == "cluster":
            assert CK % inst.G == 0
            assert 0 < inst.nbytes == size(CN, CK // inst.G, 4, itemsize) <= SMEM_LIMIT
            assert kern.cluster_threads(CN, CK // inst.G) <= 512
        else:
            assert inst.nbytes == 0


def test_ckpt_instance_refuses_a_cluster_size_that_does_not_fit():
    """A G given to the pickers (the timing tool's) is taken or refused,
    never replaced; G = 1 is the one-block kernel."""
    with pytest.raises(ValueError, match="no cluster of 8"):
        kern.pv_ckpt_instance(16, 272, 4, 4, G=8)  # the normalization's order
    with pytest.raises(ValueError, match="no cluster of 8"):
        kern.pv_ckpt_instance(16, 256, 4, 8, G=8)  # 342 KB a CTA
    with pytest.raises(ValueError, match="no cluster of 3"):
        kern.bwd_ckpt_instance(16, 256, 4, 4, G=3)
    assert kern.pv_ckpt_instance(16, 256, 4, 4, G=1) == ("device", 1, 0)
    assert kern.bwd_ckpt_instance(16, 256, 4, 8, G=16) == (
        "cluster", 16, kern.bwd_ckpt_cluster_bytes(16, 16, 4, 8))


def cluster_column_sum(ap, G: int):
    """(max, sum of exp(ap - max)) of each read's column ap (R, 5, CN, CK),
    as pv_ckpt_cluster_kernel forms them on a cluster of G CTAs: the max
    over the CTAs' maxes; CTA g's virtual threads v = q*KS + l (virtual
    thread b = q*CK + g*KS + l of block_sum's B = threads(CN*CK)) each sum
    exp(ap - max) over the flat column's elements b, b + B, ..., which all
    lie in its slice of KS = CK/G k-slots, in order; then a shuffle-down
    tree in each warp of 32 of them; then one tree over all CTAs' warp
    sums taken in virtual-warp order."""
    R, _, CN, CK = ap.shape
    NC, B, KS = CN * CK, threads(CN * CK), CK // G
    nv = B // CK * KS
    slices = [ap[..., g * KS:(g + 1) * KS] for g in range(G)]
    m = torch.stack([s.reshape(R, -1).amax(dim=1) for s in slices], 1).amax(dim=1)
    ms = torch.where(torch.isfinite(m), m, 0.0)
    wsums = []
    for g, s in enumerate(slices):
        flat = s.reshape(R, -1)  # [5][CN][KS]
        idx = []
        for v in range(nv):
            l, b = v % KS, (v // KS) * CK + g * KS + v % KS
            cells = []
            for fl in range(b, 5 * NC, B):
                st, i, j = fl // NC, (fl % NC) // CK, fl % CK
                assert j == g * KS + l  # b's cells lie in this CTA's slice
                cells.append((st * CN + i) * KS + l)
            assert cells == list(range(v, 5 * CN * KS, nv))  # the kernel's stride
            idx.append(cells)
        e = torch.exp(flat[:, torch.tensor(idx)] - ms[:, None, None])  # (R, nv, 5NC/B)
        acc = e[..., 0]
        for k in range(1, e.shape[-1]):
            acc = acc + e[..., k]
        wsums.append(_halve(acc.reshape(R, nv // 32, 32)))
    parts = []
    for w in range(B // 32):
        jw = 32 * w % CK
        g = jw // KS
        parts.append(wsums[g][:, ((32 * w // CK) * KS + jw - g * KS) // 32])
    return m, _halve(torch.stack(parts, 1))


def _columns(CN: int, CK: int, seed: int):
    """Three seeded fp32 columns (5, CN, CK): lattice-like log values with
    a third of the cells -inf; every cell -inf; values on a coarse grid,
    so that the max and many sums tie."""
    rng = np.random.default_rng(seed)
    a = rng.normal(-40.0, 15.0, (5, CN, CK))
    a[rng.random(a.shape) < 0.33] = -np.inf
    b = np.full((5, CN, CK), -np.inf)
    c = np.round(rng.normal(-3.0, 2.0, (5, CN, CK)))
    c[0, 0, :4] = c.max()
    return torch.from_numpy(np.stack([a, b, c])).to(torch.float32)


@pytest.mark.parametrize("CN,CK,G", [(16, 256, 8), (8, 128, 4), (16, 128, 4)])
def test_cluster_normalization_order_is_tree_sum(CN, CK, G):
    """Where pv_ckpt_instance takes a cluster in fp32, the cluster's max
    and sum equal the plain version's (torch.amax, _tree_sum over
    threads(CN*CK)) bit for bit."""
    assert kern.pv_ckpt_instance(CN, CK, 4, 4, G=G).name == "cluster"
    ap = _columns(CN, CK, seed=CK + G)
    m, tot = cluster_column_sum(ap, G)
    m_plain = torch.amax(ap.reshape(3, -1), dim=1)
    ms = torch.where(torch.isfinite(m_plain), m_plain, 0.0)
    tot_plain = _tree_sum(torch.exp(ap.reshape(3, -1) - ms[:, None]), threads(CN * CK))
    assert torch.equal(m, m_plain)
    assert torch.equal(tot, tot_plain)
    assert bool(torch.isneginf(m[1])) and tot[1] == 0.0  # the all -inf column
