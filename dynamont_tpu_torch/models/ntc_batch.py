"""Batched NTC (resquiggle) engine on one torch device (counterpart of
dynamont_tpu/models/ntc_batch.py): reads are bucketed into padded shapes and
each bucket runs the whole 5-state error-correcting pipeline, the mode
`dynamont-resquiggle` is named for (ref: NTC_main.cpp:8-235 +
segment.py:292-317).

The bucket program (ntc_bucket_program): TN and TK pre-pass (K7-K10) ->
plan -> K11 parameter gathers -> K13 backward -> Zb -> K15 forward,
posteriors and Viterbi -> Zf -> start slots -> K16 walk -> segment
summaries. On CUDA tensors every kernel runs on the card; on CPU tensors
their plain versions run (ops/ntc_kernels). Where CK > 128 (every wide
rung) the lattice takes the checkpointed route, as JAX's BWD_CKPT does:
K14 stores the backward row entering every 8th row and row 0, and K15's
checkpoint mode re-derives the rows in between (bit for bit the full
store's); lp stays in the working dtype.

Native 9-mer NTC (native_kmer=True with a >5-mer model, ref:
NTC_main.cpp:95-99) runs the same program at K = 4^k, as JAX's kernel
route does: the TK pre-pass becomes the checkpoint-recompute torch pass
(ops/ntc_batch.pre_tk_batch_ckpt; K9 and K10 take at most 4096 columns),
which searches the main rung's crossing within the top BIGK_TK_SEL_CAP
values.

Escalation, as in the JAX engine: a read whose 95%-mass columns overflow the
candidate caps (or whose walk overflows) re-runs in a wide rung at (16, 240)
caps ((16, 256) at native big K, JAX's scan-rung caps), at most 8 reads per
bucket; what still fails goes to the exact per-read fp64 path
(models/ntc.run_ntc), which escalates its own CAP_LADDER and refuses a read
whose (T+1) * K * 8 bytes exceed 2 GiB.

Training (train(), ref: NTC.cpp:923-1130) runs ntc_train_bucket_program
per bucket: the pre-pass and the plan as above, then K17 forward store ->
Zf -> K18 backward with the 13 term sums, the k-mer moments and row 0 ->
Zb; the host turns the sums into per-read transitions and k-mer tables
(trans_from_terms, emissions_from_moments). A read that overflows the caps
or fails a Z gate trains on the exact per-read path; training has no wide
rung, in the JAX engine either.

Devices: `device=` one, or `devices=` a list that buckets go to round-robin
(the JAX engine's `devices`), each with its own copy of the tables; a
bucket's wide and exact rungs run on the bucket's own device.

What differs from the JAX engine: the devices are given explicitly; the read
axis is padded to the bucket's own size, not to the TPU geometry's 16; the
caps are the JAX kernel route's on every device, and train() runs the
batched program in both precisions (the JAX engine runs it only on its
fp32 kernel route, every read on the exact path elsewhere); the native
big-K wide rung runs the kernel route at the scan rung's caps; training
runs at K <= 4096 only (the JAX package trains no native big-K model
either).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from dynamont_tpu_torch.constants import (
    EPSILON, NT_TRANSITIONS, NTK_TRANSITIONS, resolve_transitions,
)
from dynamont_tpu_torch.models.batch import (
    BatchItem, BatchOutput, _to_host, device_list, next_device,
)
from dynamont_tpu_torch.models.nt import _validate
from dynamont_tpu_torch.models.packing import pack_buckets, round_up, t_pad_ladder
from dynamont_tpu_torch.ops import ntc_batch as nb
from dynamont_tpu_torch.ops import ntc_kernels as kern
from dynamont_tpu_torch.ops import ntc_train_kernels as tkern
from dynamont_tpu_torch.ops import ntc_walk as nw
from dynamont_tpu_torch.ops.ntc_pre_kernels import BIG_K
from dynamont_tpu_torch.ops.ntc_train import TRAIN_THRESHOLD
from dynamont_tpu_torch.parallel.mesh import on_device
from dynamont_tpu_torch.utils.kmer import int2kmer, int2kmers_batch, seq_to_kmer_ids
from dynamont_tpu_torch.utils.logmath import logsumexp

FP32_EPSILON = 1e-6   # per-cell Z tolerance of the fp32 gates (BASELINE.md)
WIDE_CAPS = (16, 240)  # the wide rung's (cap_n, cap_k): CK = 256
BIGK_WIDE_CAPS = (16, 256)  # at native big K (JAX's scan rung): CK = 272
WIDE_READS = 8         # reads per wide-rung bucket
CKPT_CK = 128          # CK above which the lattice takes the checkpointed route
# the main rung's TK crossing is searched in the top 48 values at big K
# (JAX models/ntc_batch.py:36-40); the wide rung keeps the full width
BIGK_TK_SEL_CAP = 48


def _pre_tk(sig, T_r, tensors: dict, K: int, A: int, log_ppm: float,
            log_ppe: float, CK0: int, dtype):
    """The TK pre-pass: K9 -> K10 up to K = 4096, above it the
    checkpoint-recompute pass with JAX's chunk and selection width."""
    args = (sig, T_r, tensors["means"], tensors["c1"], tensors["c2"],
            log_ppm, log_ppe, A, CK0, dtype)
    if K <= BIG_K:
        return nb.pre_tk_batch(*args)
    sel = BIGK_TK_SEL_CAP if BIGK_TK_SEL_CAP < CK0 <= CKPT_CK else None
    return nb.pre_tk_batch_ckpt(*args, chunk=math.gcd(sig.shape[1] + 1, 128),
                                sel_cap=sel)


def ntc_bucket_program(sig, kid, N_r, T_r, tensors: dict, *, A: int, S: int,
                       log_ppm: float, log_ppe: float, trans_log: dict,
                       CN: int, CK0: int, S_max: int, dtype,
                       keep: dict | None = None,
                       ckpt: bool | None = None) -> dict:
    """One bucket through the whole NTC pipeline: sig (R, T_pad-1), kid
    (R, N2-1) int32, N_r/T_r (R,) int32, all on one device; `tensors` the
    model's means, stdevs, c1, c2 and K11's table there. Returns the
    per-read Z values, flags and segment summaries as device tensors.

    `ckpt` picks the lattice's route: the checkpointed one (K14, K15's
    checkpoint mode) or the full store (K13, K15); None takes the
    checkpointed route where CK > CKPT_CK. `keep`, when given, receives
    each lattice kernel's inputs and outputs (plan, dims, ks, table, prm,
    sig, Zb, N_r, T_r, trans_log, walk_dims, lp, choices, slots, apEf,
    fwdEf, start, rec, fin; and `bwd`, a copy of the backward store taken
    before lp is written over it, or `ckpt` and `row0`), so that each
    kernel can be held against its plain version on the bucket the engine
    ran."""
    means, stdevs = tensors["means"], tensors["stdevs"]
    K = means.shape[0]
    pn = nb.pre_tn_batch(sig, kid, N_r, T_r, means, stdevs, log_ppm, log_ppe,
                         CN, dtype)
    pk = _pre_tk(sig, T_r, tensors, K, A, log_ppm, log_ppe, CK0, dtype)
    plan, dims = nb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt, kid,
                                     N_r, K, A, S, pn.kn1, pn.kn2)
    ks = nb.gather_index(plan)
    prm = kern.tab_gather(ks, tensors["table"], dims)
    sigd = sig.to(dtype).contiguous()
    if keep is not None:
        keep.update(plan=plan, dims=dims, ks=ks, table=tensors["table"],
                    prm=prm, sig=sigd, N_r=N_r, T_r=T_r, trans_log=trans_log,
                    walk_dims=(K, A, S, S_max))
    if ckpt is None:
        ckpt = dims.CK > CKPT_CK
    if ckpt:
        ckpts, row0 = kern.bwd_ckpt(plan, dims, prm, sigd, trans_log, N_r, T_r)
        Zb = nb.ntc_zb_batch(plan, row0)
        if keep is not None:
            keep.update(ckpt=ckpts, row0=row0, Zb=Zb)
        lp, choices, slots, apEf, fwdEf = kern.pv_ckpt(
            plan, dims, prm, sigd, ckpts, Zb, trans_log, N_r, T_r)
        del ckpts
    else:
        bwd = kern.bwd(plan, dims, prm, sigd, trans_log, N_r, T_r)
        Zb = nb.ntc_zb_batch(plan, bwd[0])
        if keep is not None:
            keep.update(bwd=bwd.clone(), Zb=Zb)
        # lp is written over the backward store (row t read before written)
        lp, choices, slots, apEf, fwdEf = kern.pv(plan, dims, prm, sigd, bwd,
                                                  Zb, trans_log, T_r, out=bwd)
    Zf = nb.ntc_zf_batch(plan, fwdEf, N_r, T_r)
    i0, j0, k0, valid = nw.start_slots(plan, apEf, N_r, T_r)
    rec, fin = kern.walk(lp, choices, slots, plan, i0, j0, k0, valid, N_r,
                         T_r, K, A, S, S_max)
    if keep is not None:
        keep.update(lp=lp, choices=choices, slots=slots, apEf=apEf,
                    fwdEf=fwdEf, start=(i0, j0, k0, valid), rec=rec, fin=fin)
    seg_cnt, st_a, bp_a, start_a, k_a, med, seg_ovf = nw.finish_records(
        rec, fin, S_max)
    return dict(
        Zf_tn=pn.Zf, Zb_tn=pn.Zb, ovf_tn=pn.overflow,
        Zf_tk=pk.Zf, Zb_tk=pk.Zb, ovf_tk=pk.overflow,
        Zf=Zf, Zb=Zb, valid_start=valid,
        seg_cnt=seg_cnt, seg_state=st_a, seg_bp=bp_a, seg_start=start_a,
        seg_k=k_a, seg_med=med, seg_ovf=seg_ovf,
    )


def ntc_train_bucket_program(sig, kid, N_r, T_r, tensors: dict, *, A: int,
                             S: int, log_ppm: float, log_ppe: float,
                             trans_log: dict, CN: int, CK0: int, dtype,
                             keep: dict | None = None) -> dict:
    """One bucket's Baum-Welch sums (inputs as ntc_bucket_program's):
    pre-pass, plan, K11, K17 forward store, Zf from its row T_r-1, K18,
    Zb from K18's row 0, and each term's logsumexp over the cells of a
    read. Returns per-read Z values and flags, term_lse (13, R) in
    ops/ntc_batch.TERMS order and em (R, 3, K), as device tensors.

    `keep`, when given, receives K17's and K18's inputs and outputs (plan,
    dims, prm, sig, trans_log, N_r, T_r, K, fwd, Zf, tacc, em, b0)."""
    means, stdevs = tensors["means"], tensors["stdevs"]
    K = means.shape[0]
    pn = nb.pre_tn_batch(sig, kid, N_r, T_r, means, stdevs, log_ppm, log_ppe,
                         CN, dtype)
    pk = nb.pre_tk_batch(sig, T_r, means, tensors["c1"], tensors["c2"],
                         log_ppm, log_ppe, A, CK0, dtype)
    plan, dims = nb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt, kid,
                                     N_r, K, A, S, pn.kn1, pn.kn2)
    prm = kern.tab_gather(nb.gather_index(plan), tensors["table"], dims)
    sigd = sig.to(dtype).contiguous()
    fwd = tkern.fwd_store(plan, dims, prm, sigd, trans_log)
    r = torch.arange(dims.R, device=sig.device)
    Zf = nb.ntc_zf_batch(plan, fwd[T_r.long() - 1, r, nb.E_ST], N_r, T_r)
    tacc, em, b0 = tkern.train(plan, dims, prm, sigd, fwd, Zf, trans_log, N_r,
                               T_r, K)
    if keep is not None:
        keep.update(plan=plan, dims=dims, prm=prm, sig=sigd, trans_log=trans_log,
                    N_r=N_r, T_r=T_r, K=K, fwd=fwd, Zf=Zf, tacc=tacc, em=em, b0=b0)
    return dict(
        Zf_tn=pn.Zf, Zb_tn=pn.Zb, ovf_tn=pn.overflow,
        Zf_tk=pk.Zf, Zb_tk=pk.Zb, ovf_tk=pk.overflow,
        Zf=Zf, Zb=nb.ntc_zb_batch(plan, b0),
        term_lse=logsumexp(tacc.reshape(len(nb.TERMS), dims.R, -1), dim=2),
        em=em,
    )


def trans_from_terms(term_lse: np.ndarray) -> dict:
    """Per-read transition probabilities from the 13 raw term logsumexps
    (normalization groups, ref: NTC.cpp:1003-1030; mirrors the tail of
    ops/ntc_train.train_transitions)."""
    acc = {nm: float(v) for nm, v in zip(nb.TERMS, term_lse)}

    def lsum(vals):
        fin = [v for v in vals if not math.isinf(v)]
        if not fin:
            return -math.inf
        m = max(fin)
        return m + math.log(
            sum(math.exp(v - m) for v in vals if not math.isinf(v)))

    out = dict(acc)
    for group in (("a1", "s2", "e4", "i1", "p2"), ("e3", "p1"),
                  ("e2", "s1"), ("a2", "i2", "p3", "s3")):
        g = lsum([acc[k] for k in group])
        if not math.isinf(g):
            for k in group:
                out[k] = acc[k] - g
    result = {k: math.exp(v) for k, v in out.items()}
    result["e1"] = 1.0
    return result


def emissions_from_moments(em: np.ndarray, model) -> dict:
    """Per-read k-mer (mean, stdev) dict from the centered moment sums
    em (3, K) = [w, w*(s-mu_k), w*(s-mu_k)^2] (trainEmission,
    ref: NTC.cpp:1059-1130; threshold/selection as ops/ntc_train)."""
    norm, s1, s2 = em[0], em[1], em[2]
    nz = norm != 0
    safe = np.where(nz, norm, 1.0)
    d = s1 / safe
    keep = norm >= TRAIN_THRESHOLD
    var = np.where(keep & nz, np.maximum(s2 / safe - d * d, 0.0), 0.0)
    means = np.where(nz, np.asarray(model.means) + d, 0.0)
    stdevs = np.sqrt(var)
    out = {}
    for k in range(model.num_kmers):
        if stdevs[k] != 0.0:
            kmer = int2kmer(k, model.alphabet_size, model.kmer_size,
                            model.rna)
            out[kmer] = (float(means[k]), float(stdevs[k]))
    return out


def model_tensors(model, device, dtype) -> dict:
    """The bucket programs' `tensors` for a pore model on `device`: its
    means, stdevs, c1 and c2 in fp64 and K11's combined table in `dtype`."""
    means, c1, c2 = model.score_params()
    put = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    te = dict(means=put(means), stdevs=put(model.stdevs), c1=put(c1), c2=put(c2))
    te["table"] = nb.combined_tables(te["means"], te["c1"], te["c2"],
                                     model.alphabet_size, dtype)
    return te


class NTCBatchEngine:
    """NTC segmentation over arbitrary read lists, its buckets round-robin
    over its devices (fp32 by default). Interface as
    models.batch.BandedBatchEngine."""

    def __init__(self, model, pore: str, *, device=None, devices=None,
                 transition_overrides: dict | None = None,
                 dtype=torch.float32, batch_size: int = 16,
                 max_batch_samples: int = 2_000_000, t_pad_to: int = 2048,
                 n_pad_to: int = 256, cap_n: int = 8, cap_k: int = 120,
                 fallback: bool = True, wide_retry: bool = True,
                 native_kmer: bool = False):
        self.devices = device_list(device, devices)
        self.device = self.devices[0]
        self._next_dev = 0
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, not {dtype}")
        if model.kmer_size > 5 and not native_kmer:
            from dynamont_tpu_torch.utils.pore_model import reduce_model_to_5mer

            print(f"NTC: reducing {model.kmer_size}-mer model to 5-mer "
                  "(ref: models/9merTo5mer.py)", file=sys.stderr)
            model = reduce_model_to_5mer(model)
        self.model = model
        self.pore = pore
        self.overrides = transition_overrides
        self.dtype = dtype
        self.batch_size = batch_size
        self.max_batch_samples = max_batch_samples
        self.t_pad_to = t_pad_to
        self.n_pad_to = n_pad_to
        self.cap_n = cap_n
        self.cap_k = cap_k
        self.fallback = fallback
        self.wide_retry = wide_retry
        self.wide_caps = BIGK_WIDE_CAPS if model.num_kmers > BIG_K else WIDE_CAPS
        self._eps = EPSILON if dtype == torch.float64 else FP32_EPSILON
        ntk = resolve_transitions(NTK_TRANSITIONS[pore], transition_overrides)
        self.trans_log = {k: math.log(v) for k, v in ntk.items()}
        nt = NT_TRANSITIONS[pore]
        self.log_ppm, self.log_ppe = math.log(nt["m1"]), math.log(nt["e2"])
        # the tables once per distinct device; `tensors` are the first's
        self._tensors = {}
        for d in self.devices:
            if d not in self._tensors:
                self._tensors[d] = model_tensors(model, d, dtype)
        self.tensors = self._tensors[self.device]
        # wall-clock accounting across run() calls (see --profile);
        # device_buckets counts the buckets sent to each entry of the list
        self.profile = {"buckets": 0, "reads": 0, "dispatch_s": 0.0,
                        "collect_s": 0.0, "wide_retries": 0, "wide_s": 0.0,
                        "exact_retries": 0, "exact_s": 0.0,
                        "device_buckets": [0] * len(self.devices)}

    # -- batching ----------------------------------------------------------
    def _buckets(self, idxs, items, batch_size: int):
        """Row-optimal packing (models/packing.py); one thread block per
        read, so group 1."""
        idxs = list(idxs)
        for b in pack_buckets([len(items[i].signal) for i in idxs],
                              batch_size=batch_size,
                              max_batch_samples=self.max_batch_samples,
                              t_pad_to=self.t_pad_to, group=1):
            yield [idxs[p] for p in b]

    def _pad_bucket(self, gidx, items):
        T_arr = np.array([len(items[i].signal) + 1 for i in gidx], np.int32)
        kmer_ids = [np.asarray(seq_to_kmer_ids(items[i].read, self.model.kmer_size,
                                               self.model.alphabet_size), np.int32)
                    for i in gidx]
        N_arr = np.array([len(k) + 1 for k in kmer_ids], np.int32)
        T_pad = t_pad_ladder(int(T_arr.max()), self.t_pad_to)
        N2 = round_up(int(N_arr.max()), self.n_pad_to)
        # the bucket carries the signal in fp32 in both precisions, as the
        # JAX engine's does (the exact per-read path reads it in fp64)
        sig = np.zeros((len(gidx), T_pad - 1), np.float32)
        kid = np.zeros((len(gidx), N2 - 1), np.int32)
        for j, i in enumerate(gidx):
            sig[j, : T_arr[j] - 1] = items[i].signal
            kid[j, : N_arr[j] - 1] = kmer_ids[j]
        return T_arr, N_arr, sig, kid, N2

    # -- execution ---------------------------------------------------------
    def dispatch(self, items: list[BatchItem]):
        """Validate and queue every bucket on the device, starting the
        results' copies to the host; returns a handle for collect()."""
        outputs: list[BatchOutput | None] = [None] * len(items)
        valid: list[int] = []
        for i, it in enumerate(items):
            try:
                _validate(len(it.signal), len(it.read), self.model.kmer_size)
            except SystemExit as e:
                outputs[i] = BatchOutput(
                    it, None, math.nan,
                    f"input validation failed (reference exit {e.code})")
                continue
            valid.append(i)
        t0 = time.perf_counter()
        pending = [self._dispatch(gidx, items, self.cap_n, self.cap_k)
                   for gidx in self._buckets(valid, items, self.batch_size)]
        self.profile["dispatch_s"] += time.perf_counter() - t0
        return items, outputs, valid, pending

    def collect(self, handle) -> list[BatchOutput]:
        """Wait for the handle's buckets, build outputs, and run the
        escalation ladder on the reads that need it."""
        items, outputs, valid, pending = handle
        t1 = time.perf_counter()
        # the reads to retry, by the device of their bucket
        retry: dict = {}
        for bucket in pending:
            retry.setdefault(bucket[-1], []).extend(
                self._collect(bucket, items, outputs))
        n_retry = sum(len(v) for v in retry.values())
        t2 = time.perf_counter()
        use_wide = bool(n_retry) and self.fallback and self.wide_retry
        exact = {dev: self._run_wide(idxs, items, outputs, dev) if use_wide else idxs
                 for dev, idxs in retry.items()}
        t3 = time.perf_counter()
        for dev, idxs in exact.items():
            for i in idxs:
                outputs[i] = self._run_exact(items[i], dev)
        pr = self.profile
        pr["buckets"] += len(pending)
        pr["reads"] += len(valid)
        pr["collect_s"] += t2 - t1
        pr["wide_retries"] += n_retry if use_wide else 0
        pr["wide_s"] += t3 - t2
        pr["exact_retries"] += sum(len(v) for v in exact.values())
        pr["exact_s"] += time.perf_counter() - t3
        return outputs  # type: ignore[return-value]

    def run(self, items: list[BatchItem]) -> list[BatchOutput]:
        return self.collect(self.dispatch(items))

    def train(self, items: list[BatchItem], exact=None) -> list:
        """Per-read Baum-Welch estimates: each bucket through
        ntc_train_bucket_program in the engine's dtype; a read that
        overflows the caps or fails a Z gate goes to `exact(item, device)`
        on its bucket's device, by default the exact per-read path in
        train mode (_train_exact). Returns, per read,
        (trained_transitions, trained_emissions, Z) or an Exception."""
        if self.model.num_kmers > BIG_K:
            raise NotImplementedError(
                f"NTC training at K = {self.model.num_kmers}: training runs "
                f"the dense TK pre-pass kernels, which take K <= {BIG_K}")
        exact = exact or self._train_exact
        outputs: list = [None] * len(items)
        valid: list[int] = []
        for i, it in enumerate(items):
            try:
                _validate(len(it.signal), len(it.read), self.model.kmer_size)
                valid.append(i)
            except SystemExit as e:
                outputs[i] = RuntimeError(
                    f"input validation failed (reference exit {e.code})")
        K = self.model.num_kmers
        for gidx in self._buckets(valid, items, self.batch_size):
            dev = next_device(self)
            T_arr, N_arr, host = self._train_bucket(gidx, items, dev=dev)
            for j, i in enumerate(gidx):
                if host["ovf_tn"][j] or host["ovf_tk"][j]:
                    err = "cap overflow"
                else:
                    err = self._z_errors(host, j, int(T_arr[j]), int(N_arr[j]), K,
                                         (self.cap_n, self.cap_k))
                if err is not None and not self.fallback:
                    outputs[i] = RuntimeError(f"{err} (no fallback)")
                elif err is not None:
                    self.profile["exact_retries"] += 1
                    outputs[i] = exact(items[i], dev)
                else:
                    outputs[i] = (trans_from_terms(host["term_lse"][:, j]),
                                  emissions_from_moments(host["em"][j], self.model),
                                  float(host["Zf"][j]))
        return outputs

    def _train_bucket(self, gidx, items, keep: dict | None = None,
                      dev: torch.device | None = None):
        """(T_arr, N_arr, host results) of one bucket's training program,
        on `dev` (the engine's first device by default)."""
        dev = self.device if dev is None else dev
        T_arr, N_arr, sig, kid, _ = self._pad_bucket(gidx, items)
        put = lambda a: torch.from_numpy(a).to(dev)
        with on_device(dev):
            res = ntc_train_bucket_program(
                put(sig).to(self.dtype), put(kid), put(N_arr), put(T_arr),
                self._tensors[dev], A=self.model.alphabet_size,
                S=self.model.kmer_size, log_ppm=self.log_ppm,
                log_ppe=self.log_ppe, trans_log=self.trans_log, CN=self.cap_n,
                CK0=self.cap_k, dtype=self.dtype, keep=keep)
            return T_arr, N_arr, {k: v.cpu().numpy() for k, v in res.items()}

    def _train_exact(self, it: BatchItem, dev: torch.device | None = None):
        """The exact per-read fp64 path in train mode, on `dev` (the
        engine's first device by default); its Z-gate errors are the
        read's result."""
        from dynamont_tpu_torch.models.ntc import (
            NTCPreprocessError, NTCZError, run_ntc,
        )

        try:
            res = run_ntc(it.signal, it.read, self.model, self.pore,
                          self.overrides, mode="train",
                          device=self.device if dev is None else dev,
                          validate=False)
        except (NTCPreprocessError, NTCZError) as e:
            return e
        return res.trained_transitions, res.trained_emissions, res.Z

    def _dispatch(self, gidx, items, cap_n: int, cap_k: int,
                  keep: dict | None = None, ckpt: bool | None = None,
                  dev: torch.device | None = None):
        """Queue one bucket on `dev` (the next device round-robin by
        default); returns its handle for _collect."""
        dev = next_device(self) if dev is None else dev
        T_arr, N_arr, sig, kid, N2 = self._pad_bucket(gidx, items)
        # segment cap: one per base plus polish slack (overflow -> ladder)
        S_max = round_up(N2 + N2 // 4 + 64, 128)
        put = lambda a: torch.from_numpy(a).to(dev)
        with on_device(dev):
            res = ntc_bucket_program(
                put(sig).to(self.dtype), put(kid), put(N_arr), put(T_arr),
                self._tensors[dev], A=self.model.alphabet_size,
                S=self.model.kmer_size, log_ppm=self.log_ppm,
                log_ppe=self.log_ppe, trans_log=self.trans_log, CN=cap_n,
                CK0=cap_k, S_max=S_max, dtype=self.dtype, keep=keep, ckpt=ckpt)
            host = {k: _to_host(v) for k, v in res.items()}
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
        return gidx, T_arr, N_arr, host, done, (cap_n, cap_k), dev

    def _collect(self, bucket, items, outputs) -> list[int]:
        gidx, T_arr, N_arr, host, done, caps, _ = bucket
        if done is not None:
            done.synchronize()
        host = {k: v.numpy() for k, v in host.items()}
        K = self.model.num_kmers
        retry: list[int] = []
        for j, i in enumerate(gidx):
            it = items[i]
            T, N = int(T_arr[j]), int(N_arr[j])
            flags = [f for f in ("ovf_tn", "ovf_tk", "seg_ovf") if host[f][j]]
            if not host["valid_start"][j]:
                flags.append("no_valid_start")
            if flags:
                if not self.fallback:
                    print(f"ntc fallback[{i}]: {','.join(flags)}", file=sys.stderr)
                retry.append(i)
                continue
            err = self._z_errors(host, j, T, N, K, caps)
            if err is not None:
                outputs[i] = BatchOutput(it, None, float(host["Zf"][j]), err)
                continue
            segs = self._renormalize_medians(host, j, self._format_segments(host, j))
            outputs[i] = BatchOutput(it, segs, float(host["Zf"][j]))
        return retry

    def _z_errors(self, host, j, T, N, K, caps):
        # "matrices" counts the sparse lattice actually evaluated (T x 5
        # states x CN x CK slots): T*N*K would let the per-cell tolerance
        # admit 1000+ nats of divergence at T=16k
        cap_n, cap_k = caps
        checks = (
            ("preProcTN", host["Zf_tn"][j], host["Zb_tn"][j], T * N),
            ("preProcTK", host["Zf_tk"][j], host["Zb_tk"][j], T * K),
            ("matrices", host["Zf"][j], host["Zb"][j],
             T * 5 * cap_n * (cap_k + cap_n)),
        )
        for name, zf, zb, cells in checks:
            zf, zb = float(zf), float(zb)
            if math.isinf(zf) or math.isinf(zb) or abs(zf - zb) / cells > self._eps:
                if name == "matrices":
                    return (f"Z values between matrices do not match! forZ: {zf}, "
                            f"backZ: {zb}")
                return f"Z values of {name} do not match! Zf: {zf}, Zb: {zb}"
        return None

    def _format_segments(self, host, j):
        """Summaries -> (state, basepos, start_t, prob, polish_kmer) in read
        order, as models/ntc.run_ntc gives them."""
        cnt = int(host["seg_cnt"][j])
        if cnt <= 0:
            return []
        m = self.model
        rev = slice(cnt - 1, None, -1)
        polish = int2kmers_batch(host["seg_k"][j, rev], m.alphabet_size,
                                 m.kmer_size, m.rna)
        return [("P" if st else "M", int(bp), int(t0), float(p), pk)
                for st, bp, t0, p, pk in zip(
                    host["seg_state"][j, rev].tolist(), host["seg_bp"][j, rev].tolist(),
                    host["seg_start"][j, rev].tolist(), host["seg_med"][j, rev].tolist(),
                    polish)]

    def _renormalize_medians(self, host, j, segs):
        """fp32 posteriors are normalized by each column's own logsumexp
        and need nothing; fp64 ones by Zb, so the medians are rescaled to
        the reference's Zf (a uniform log-shift, exact because the grouped
        median is monotone in the probabilities)."""
        if self.dtype != torch.float64:
            return segs
        diff = float(host["Zb"][j]) - float(host["Zf"][j])
        if diff == 0.0:
            return segs
        # reads with |Zb-Zf| this large fail _z_errors first
        scale = math.exp(min(diff, 700.0))
        return [(st, bp, t0, p * scale, pk) for st, bp, t0, p, pk in segs]

    def _run_wide(self, idxs: list[int], items, outputs,
                  dev: torch.device | None = None) -> list[int]:
        """The wide rung on `dev` (the engine's first device by default):
        overflowing reads re-run at self.wide_caps in buckets of at most
        WIDE_READS. Returns the reads that still overflow or fail their Z
        gates (a wide-rung Z failure is not terminal: the exact path may
        succeed)."""
        dev = self.device if dev is None else dev
        still: list[int] = []
        for gidx in self._buckets(idxs, items, min(self.batch_size, WIDE_READS)):
            bucket = self._dispatch(gidx, items, *self.wide_caps, dev=dev)
            still += self._collect(bucket, items, outputs)
            for i in gidx:
                if (i not in still and outputs[i] is not None
                        and outputs[i].error is not None):
                    outputs[i] = None
                    still.append(i)
        if still:
            print(f"ntc wide-cap rung: {len(still)}/{len(idxs)} reads still "
                  "overflow; falling to exact fp64", file=sys.stderr)
        return still

    def _run_exact(self, it: BatchItem,
                   dev: torch.device | None = None) -> BatchOutput:
        """The exact per-read fp64 path, on `dev` (the engine's first
        device by default)."""
        if not self.fallback:
            return BatchOutput(it, None, math.nan,
                               "candidate cap overflow (no fallback)")
        # the per-read path holds four (T, K) fp64 matrices: at native big K
        # a long read would ask for tens of GB (JAX models/ntc_batch.py:883-898)
        K = self.model.num_kmers
        if (len(it.signal) + 1) * K * 8 > 2**31:
            return BatchOutput(
                it, None, math.nan,
                "candidate cap overflow (read too long for the exact "
                f"fp64 path at K={K}; retry with larger caps)")
        from dynamont_tpu_torch.models.ntc import (
            NTCPreprocessError, NTCZError, run_ntc,
        )

        try:
            res = run_ntc(it.signal, it.read, self.model, self.pore,
                          self.overrides, device=self.device if dev is None else dev,
                          validate=False)
            return BatchOutput(it, res.segments, res.Z)
        except (NTCPreprocessError, NTCZError) as e:
            return BatchOutput(it, None, math.nan, str(e))
