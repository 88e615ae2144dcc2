"""The NTC training kernels' instances (K17 ntc_fwd_store and K18 ntc_train,
each a shared-column instance and a device-memory one) on the CPU: which
instance each shape takes, and the shared K18's order of the k-mer moments.

The kernels run only on a card (tests/test_torch_cuda_kernels.py holds
every instance bit for bit against its plain version there). Here:
  - fwd_store_instance / train_instance at the engine's main caps (8, 120)
    and wide caps (16, 240), in fp32 and fp64, each shared instance's
    bytes, region by region as csrc/ntc_train.cu lays them out, within one
    block's 232448 bytes;
  - the wrappers' `instance` argument: the device instance runs at every
    shape, a shared one only where the picker gives it;
  - moments_two_pass, a reference written from train_shared_kernel's
    moments (every cell's w of a row first, then each live k-slot's sums
    over its n-slots in n order, added to the slot's bin, rows in
    descending t), held bit for bit against ntc_train_batch's em on the
    three short reads in both dtypes.
"""

import pytest
import torch

from dynamont_tpu_torch.models.batch import BatchItem
from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
from dynamont_tpu_torch.models.registry import load_model_for_pore
from dynamont_tpu_torch.ops import ntc_batch as nb
from dynamont_tpu_torch.ops import ntc_train_kernels as tk
from dynamont_tpu_torch.ops.ntc_pre_kernels import threads
from dynamont_tpu_torch.ops.ntc_probe_kernels import stage_bytes
from dynamont_tpu_torch.utils.synthetic import make_read

SMEM_LIMIT = 232448  # shared memory one block of an H100 may take
A = 4
# (cap_n, cap_k) -> (CN, CK): the main rung and the wide one
RUNGS = {(8, 120): (8, 128), (16, 240): (16, 256)}
# (CK, itemsize) -> (K17's instance, K18's instance and whether it stages
# the forward rows)
WANT = {
    (128, 4): ("shared", ("shared", True)),
    (128, 8): ("shared", ("shared", False)),  # fp64: 525 KB with the forward rows
    (256, 4): ("shared", ("device", False)),  # K18: two columns alone 160 KB
    (256, 8): ("device", ("device", False)),
}


def _al16(b: int) -> int:
    return (b + 15) // 16 * 16


def fwd_store_shared_bytes(CN: int, CK: int, isz: int) -> int:
    """fwd_store_shared_kernel's regions: columns t - 1 and t, the score,
    the I-chain flags, two stages of pv_shared_kernel's PvStage."""
    NC = CN * CK
    stage = (_al16((3 * CN + CK + A * CK) * 4) + _al16(2 * NC) + _al16(NC)
             + _al16((3 * CK + 3 * CN + 1) * isz))
    return 2 * 5 * NC * isz + NC * isz + _al16(NC) + 2 * stage


def train_shared_bytes(CN: int, CK: int, isz: int, staged: bool) -> int:
    """train_shared_kernel's regions: rows t + 1 and t, train_column's
    scratch (without staged forward rows, their E and I too), with them the
    13 accumulators, the moments' w, and three slots of a staged row
    (stage_bytes at C = 1), its live and ks and, staged, its forward row,
    and the slots' three mbarriers (8 bytes each, the region 16-aligned)."""
    NC = CN * CK
    scratch = _al16(4 * NC * isz + NC) + (0 if staged else 2 * NC * isz)
    slot = (stage_bytes(nb.PlanDims(1, CN, CK, A), 1, isz) + _al16(CK) + _al16(4 * CK)
            + (5 * NC * isz if staged else 0))
    return (2 * 5 * NC * isz + scratch + (13 * NC * isz if staged else 0) + NC * isz
            + 3 * slot + 32)


@pytest.mark.parametrize("caps", list(RUNGS))
@pytest.mark.parametrize("itemsize", [4, 8])
def test_train_instances_by_shape(caps, itemsize):
    CN, CK = RUNGS[caps]
    want_fwd, (want_train, staged) = WANT[CK, itemsize]
    fi = tk.fwd_store_instance(CN, CK, A, itemsize)
    ti = tk.train_instance(CN, CK, A, itemsize)
    assert (fi.name, ti.name, ti.fwd_staged) == (want_fwd, want_train, staged)
    NC, NT = CN * CK, threads(CN * CK)
    if fi.name == "shared":
        assert fi.nbytes == fwd_store_shared_bytes(CN, CK, itemsize) <= SMEM_LIMIT
        assert NT > CK  # phase 2 leaves threads to prefetch and store
    else:
        assert fwd_store_shared_bytes(CN, CK, itemsize) > SMEM_LIMIT
        assert fi.nbytes == 2 * NC * itemsize + NC
    if ti.name == "shared":
        assert ti.nbytes == train_shared_bytes(CN, CK, itemsize, staged) <= SMEM_LIMIT
        if not staged:
            assert train_shared_bytes(CN, CK, itemsize, True) > SMEM_LIMIT
        assert NT - CK >= CK and CK % 32 == 0  # the moments' slots on idle warps
    else:
        assert train_shared_bytes(CN, CK, itemsize, False) > SMEM_LIMIT
        assert ti.nbytes <= SMEM_LIMIT


@pytest.mark.parametrize("itemsize", [4, 8])
def test_instance_argument_takes_device_anywhere_and_shared_where_picked(itemsize):
    for (CN, CK) in RUNGS.values():
        dims = nb.PlanDims(2, CN, CK, A)
        for name, pick in (("ntc_fwd_store", tk.fwd_store_instance),
                           ("ntc_train", tk.train_instance)):
            picked = pick(CN, CK, A, itemsize).name
            assert tk._pick(name, pick, dims, itemsize, None) == picked
            assert tk._pick(name, pick, dims, itemsize, "device") == "device"
            if picked == "shared":
                assert tk._pick(name, pick, dims, itemsize, "shared") == "shared"
            else:
                with pytest.raises(ValueError, match="does not run"):
                    tk._pick(name, pick, dims, itemsize, "shared")


def moments_two_pass(plan, prm, sig, fwd, bwd, Z, K: int):
    """em (R, 3, K) as train_shared_kernel forms it: per row t >= 1, in
    descending t, first every cell's w (the logaddexp over the states of
    fwd + bwd - Z in state order, exp; 0 where not allowed), then each
    live k-slot's sums of w, w*d and w*d*d over its n-slots in n order (d =
    sig[t - 1] - mu_k), each added to the slot's bin."""
    T_pad, R, _, CN, CK = fwd.shape
    em = torch.zeros((R, 3, K), dtype=sig.dtype)
    Zc = Z[:, None, None]
    for t in range(T_pad - 1, 0, -1):
        f, o = fwd[t], bwd[t]
        lw = (f[:, 0] + o[:, 0]) - Zc
        for st in range(1, 5):
            lw = torch.logaddexp(lw, (f[:, st] + o[:, st]) - Zc)
        w = torch.where(plan.allowed[t], torch.exp(lw), 0.0)  # (R, CN, CK)
        d = sig[:, t - 1, None] - prm.mu_k[t]                  # (R, CK)
        sw, swd, swdd = w[:, 0], w[:, 0] * d, (w[:, 0] * d) * d
        for i in range(1, CN):
            wd = w[:, i] * d
            sw, swd, swdd = sw + w[:, i], swd + wd, swdd + wd * d
        for r in range(R):
            live = plan.live[t, r]
            k = plan.ks[t, r][live].long()
            for q, s in enumerate((sw, swd, swdd)):
                em[r, q, k] = em[r, q, k] + s[r][live]
    return em


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_moments_two_pass_is_ntc_train_batch(dtype):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of tiny plain ops
    try:
        model = load_model_for_pore("rna002")
        items = [BatchItem(*make_read(model, n_bases=n, seed=s))
                 for s, n in ((0, 25), (1, 31), (2, 18))]
        eng = NTCBatchEngine(model, "rna002", device="cpu", dtype=dtype, t_pad_to=64,
                             n_pad_to=16)
        k: dict = {}
        eng._train_bucket(list(range(len(items))), items, keep=k)
        bwd = torch.empty_like(k["fwd"])
        _, em, _ = nb.ntc_train_batch(k["plan"], k["dims"], k["prm"], k["sig"], k["fwd"],
                                      k["Zf"], k["trans_log"], k["N_r"], k["T_r"], k["K"],
                                      bwd_out=bwd)
    finally:
        torch.set_num_threads(n_threads)
    assert torch.equal(em, k["em"])
    got = moments_two_pass(k["plan"], k["prm"], k["sig"], k["fwd"], bwd, k["Zf"], k["K"])
    assert (em[:, 0] > 0).sum() >= 20 * len(items)
    assert torch.equal(got, em)
