"""Mini-batch Baum-Welch training loop, basic and resquiggle (NTC) mode,
on one torch device (counterpart of dynamont_tpu/training/trainer.py; ref:
src/python/segmentation/train.py).

The pooling (ManagedList sliding windows), the polyA skip, the per-batch
checkpoints and the params.csv rows with the post-update Z change follow
the JAX Trainer line for line, so both packages write the same files; the
pieces without JAX (ManagedList, find_resume_state, read_passes_filters)
are copied from it, the k-mer model reader and writer come from the
port's copy of utils/pore_model. What differs:

  * the device is explicit, and precision "auto" means fp32 on CUDA and
    fp64 on the CPU;
  * resquiggle mode trains each batch through a fresh batched NTC engine
    (models/ntc_batch.NTCBatchEngine.train, kernels K7-K11, K17, K18) on
    the current k-mer tables and transitions, in both precisions; the JAX
    Trainer does so only on its TPU and runs every read on the exact path
    elsewhere;
  * a basic-mode batch pads T to a multiple of 512 (the JAX fp32 path
    pads to 2048 rows and 256 positions so that XLA can reuse a compile;
    here nothing is compiled per shape, and the estimates do not depend on
    the padding);
  * nothing hides the device: an error to build or launch a kernel ends the
    run. Only per-read data errors take the per-read path — in resquiggle
    mode a read failing any gate or cap re-runs on the exact fp64 rung, as
    in JAX; a read failing the input contract or the basic mode's Z gate
    (fp32 or fp64) is skipped, as JAX skips it — where the JAX Trainer
    re-runs a whole batch read by read on any exception;
  * the post-update Z of every read comes from one more batched pass in
    both modes and precisions (the JAX fp64 path re-runs each read alone);
  * --distributed is not ported yet.
"""

from __future__ import annotations

import math
import os
import sys
from collections import deque
from datetime import datetime
from os.path import join

import numpy as np
import torch

from dynamont_tpu_torch.constants import TRAIN_INIT_NT, TRAIN_INIT_NTK, is_rna
from dynamont_tpu_torch.utils.kmer import int2kmer, seq_to_kmer_ids
from dynamont_tpu_torch.utils.pore_model import (
    pore_model_from_dict, read_kmer_models, write_kmer_models,
)
from dynamont_tpu_torch.models.nt import _validate
from dynamont_tpu_torch.models.ntc import NTCPreprocessError, NTCZError, run_ntc
from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops.nt_banded_train import banded_batch_train

T_PAD_TO = 512


class ManagedList:
    """Sliding-window estimator (ref: train.py:19-46)."""

    def __init__(self, values, max_size: int = 100):
        self.values = deque(values, maxlen=max_size)

    def add(self, value):
        self.values.append(value)

    def get_list(self):
        return list(self.values)

    def mean(self):
        if not self.values:
            return None
        return float(np.mean(self.values))

    def median(self):
        if not self.values:
            return None
        return float(np.median(self.values))

    def __repr__(self):
        return f"ManagedList({list(self.values)})"


def nucleotide_ratios(seq: str) -> dict:
    """Fraction of each base (ref: FileIO.py countNucleotides + ratio)."""
    L = max(1, len(seq))
    return {b: seq.count(b) / L for b in "ACGT"}


def find_resume_state(outdir: str, param_names) -> dict | None:
    """Last trainable position recorded under outdir, or None.

    Parses params.csv (tolerating a final partial line from an interrupted
    run — the checkpoint model and the transition values are flushed before
    the post-update Z re-evaluation appends Zchange) and returns the last
    epoch/batch, the reads count, the transition values, and how many
    batches of the last epoch are already done."""
    csv_path = join(outdir, "params.csv")
    if not os.path.exists(csv_path):
        return None
    n_params = len(param_names)
    last = None
    per_epoch: dict = {}
    with open(csv_path) as f:
        next(f, None)  # header
        for line in f:
            fields = line.rstrip("\n").split(",")
            if len(fields) < 3 + n_params:
                continue
            try:
                e, b, r = int(fields[0]), int(fields[1]), int(fields[2])
                vals = [float(v) for v in fields[3:3 + n_params]]
            except ValueError:
                continue
            per_epoch[e] = per_epoch.get(e, 0) + 1
            last = (e, b, r, vals)
    if last is None:
        return None
    e, b, r, vals = last
    ckpt = join(outdir, f"trained_{e}_{b}.model")
    if not os.path.exists(ckpt):
        return None
    return {
        "epoch": e, "batch": b, "reads": r, "ckpt": ckpt,
        "transitions": dict(zip(param_names, vals)),
        "batches_done_in_epoch": per_epoch[e],
    }


def read_passes_filters(seq: str) -> bool:
    """Repeat-artifact filter: skip reads >=60% one nucleotide
    (ref: train.py:139-146)."""
    return not any(v >= 0.6 for v in nucleotide_ratios(seq).values())


class Trainer:
    """One training run over batches of reads."""

    def __init__(self, mode: str, pore: str, outdir: str, model_path: str,
                 batch_size: int = 24, epochs: int = 1, resume: bool = False,
                 precision: str = "auto", distributed: bool = False, *,
                 device):
        if mode not in ("basic", "resquiggle"):
            raise ValueError(f"mode {mode!r}")
        if distributed:
            raise NotImplementedError(
                "--distributed training is not yet ported to the PyTorch "
                "package")
        if precision not in ("auto", "fp64", "fp32"):
            raise ValueError(f"precision {precision!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
        if precision == "auto":
            precision = "fp32" if self.device.type == "cuda" else "fp64"
            print(f"precision auto -> {precision} ({self.device.type} device)",
                  file=sys.stderr)
        self.mode = mode
        self.precision = precision
        self.dtype = torch.float32 if precision == "fp32" else torch.float64
        self.pore = pore
        self.rna = is_rna(pore)
        self.outdir = outdir
        self.batch_size = batch_size
        self.epochs = epochs
        # reads that took the per-read fp64 NTC rung (train and calcZ)
        self.fp64_reads = 0
        os.makedirs(outdir, exist_ok=True)

        init = TRAIN_INIT_NT if mode == "basic" else TRAIN_INIT_NTK
        state = find_resume_state(outdir, list(init)) if resume else None
        self.resume_epoch = 0
        self.resume_skip_batches = 0
        if state is not None:
            # continue from the last checkpoint; like a reference restart
            # via --model_path, the ManagedList windows restart from the
            # pooled values (their history is not persisted)
            model_path = state["ckpt"]
            self.resume_epoch = state["epoch"]
            self.resume_skip_batches = state["batches_done_in_epoch"]
            print(
                f"resume: epoch {state['epoch']}, batch {state['batch']} "
                f"({state['reads']} reads done) from {state['ckpt']}",
                file=sys.stderr,
            )

        self.kmer_models = read_kmer_models(model_path)
        self.transition_params = (
            dict(state["transitions"]) if state is not None else dict(init)
        )

        # ManagedList pools (ref: train.py:110-111)
        self.param_collector = {
            kmer: (ManagedList([m]), ManagedList([s]))
            for kmer, (m, s) in self.kmer_models.items()
        }
        self.param_collector.update(
            {p: ManagedList([v]) for p, v in self.transition_params.items()}
        )

        csv_path = join(outdir, "params.csv")
        if state is None:
            self.ckpt_path = join(outdir, "trained_0_0.model")
            write_kmer_models(self.ckpt_path, self.kmer_models)
            self.params_csv = open(csv_path, "w")
            self.params_csv.write(
                "epoch,batch,read,"
                + ",".join(self.transition_params) + ",Zchange\n"
            )
            self.reads_done = 0
            self.batch_num = 0
        else:
            self.ckpt_path = state["ckpt"]
            # terminate a partial final row (interrupt between the params
            # flush and the Zchange append) so new rows don't merge onto it
            with open(csv_path, "rb") as f:
                f.seek(0, 2)
                size = f.tell()
                newline_missing = False
                if size:
                    f.seek(size - 1)
                    newline_missing = f.read(1) != b"\n"
            self.params_csv = open(csv_path, "a")
            if newline_missing:
                self.params_csv.write("\n")
            self.reads_done = state["reads"]
            self.batch_num = state["batch"]

    # -- per-read estimates ------------------------------------------------
    def _train_batch(self, jobs: list) -> list:
        """All valid reads of a batch through the batched banded Baum-Welch
        op in one pass. Returns (trained_transitions, trained_emissions, Z)
        or an Exception per job; a read failing the Z gate gets its gate
        error in both precisions, and the batch's pool leaves it out, as
        in the JAX Trainer."""
        model = pore_model_from_dict(self.kmer_models, self.rna)
        out: list = [None] * len(jobs)
        live = []
        for i, job in enumerate(jobs):
            try:
                _validate(len(job.signal), len(job.read), model.kmer_size)
            except SystemExit as e:
                out[i] = ValueError(f"input validation failed (reference exit {e.code})")
                continue
            live.append(i)
        if not live:
            return out
        kids = [seq_to_kmer_ids(jobs[i].read, model.kmer_size,
                                model.alphabet_size) for i in live]
        batch = bb.prepare_batch([jobs[i].signal for i in live], kids, model,
                                 device=self.device, dtype=self.dtype,
                                 t_pad_to=T_PAD_TO)
        kid_pad = np.zeros((len(live), max(len(k) for k in kids)), np.int32)
        for i, k in enumerate(kids):
            kid_pad[i, : len(k)] = k
        res = banded_batch_train(batch, math.log(self.transition_params["m1"]),
                                 math.log(self.transition_params["e2"]),
                                 kid_pad, model.num_kmers)
        Zf, Zb = (x.cpu().numpy().astype(np.float64) for x in (res.Zf, res.Zb))
        m1, e2, means, stdevs, mask = (
            x.cpu().numpy() for x in (res.m1, res.e2, res.means, res.stdevs,
                                      res.kmer_mask))
        T = np.array([len(jobs[i].signal) + 1 for i in live])
        ok = bb.check_z_batch(Zf, Zb, T, batch.B, self.dtype)
        for r, i in enumerate(live):
            if not ok[r]:
                out[i] = RuntimeError(f"Z values between matrices do not "
                                      f"match! Zf: {Zf[r]}, Zb: {Zb[r]}")
                continue
            trans = {"m1": float(m1[r]), "e1": 1.0, "e2": float(e2[r])}
            emis = {
                int2kmer(k, model.alphabet_size, model.kmer_size, model.rna):
                    (float(means[r, k]), float(stdevs[r, k]))
                for k in np.nonzero(mask[r])[0]
            }
            out[i] = (trans, emis, float(Zb[r]))
        return out

    def _train_batch_ntc(self, jobs: list, exact) -> list:
        """All reads of a batch through a fresh batched NTC engine on the
        current k-mer tables and transitions (NTCBatchEngine.train); a read
        that overflows its caps or fails a Z gate gets exact(job)."""
        model = pore_model_from_dict(self.kmer_models, self.rna)
        eng = NTCBatchEngine(model, self.pore, device=self.device,
                             transition_overrides=self.transition_params,
                             dtype=self.dtype, batch_size=max(1, len(jobs)))
        return eng.train(jobs, exact=exact)

    def _rung(self, job, mode: str):
        """The exact per-read fp64 NTC rung (resquiggle mode); a Z-gate
        error is the read's result, any other error propagates."""
        self.fp64_reads += 1
        model = pore_model_from_dict(self.kmer_models, self.rna)
        try:
            return run_ntc(job.signal, job.read, model, self.pore,
                           self.transition_params, mode=mode,
                           device=self.device, validate=False)
        except (NTCPreprocessError, NTCZError) as e:
            return e

    def _train_read(self, job):
        res = self._rung(job, "train")
        if isinstance(res, Exception):
            return res
        return res.trained_transitions, res.trained_emissions, res.Z

    def _calc_z(self, job):
        res = self._rung(job, "calcZ")
        return res if isinstance(res, Exception) else (None, None, res.Z)

    def _post_z(self, jobs: list, epoch: int) -> np.ndarray:
        """Post-update Z of every read (the reference re-runs each read
        with --calcZ, train.py:248-257): one more batched pass under the
        updated parameters."""
        post_z = np.zeros(len(jobs))
        for j, r in enumerate(self._batch(jobs, self._calc_z)):
            if isinstance(r, Exception):
                # Z stays 0, as in the reference
                print(f"No segmentation calculated for {jobs[j].readid} in "
                      f"{epoch} calcZ: {r}", file=sys.stderr)
                continue
            post_z[j] = r[2]
        return post_z

    def _batch(self, jobs: list, exact) -> list:
        if self.mode == "basic":
            return self._train_batch(jobs)
        return self._train_batch_ntc(jobs, exact)

    # -- batch update ------------------------------------------------------
    def process_batch(self, jobs: list, epoch: int) -> float | None:
        """Train one batch, pool estimates, checkpoint, return mean dZ
        (ref: train.py:205-269)."""
        self.batch_num += 1
        print("============================", file=sys.stderr)
        print(
            f"{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}: Training epoch: "
            f"{epoch}, reads: {self.reads_done}, batch: {self.batch_num}\n"
            f"{self.transition_params}",
            file=sys.stderr,
        )
        kmer_seen = set()
        pre_z = np.zeros(len(jobs))
        results = self._batch(jobs, self._train_read)
        for j, job in enumerate(jobs):
            r = results[j]
            if isinstance(r, Exception):
                print(f"No segmentation calculated for {job.readid} in {epoch}: {r}",
                      file=sys.stderr)
                continue
            trained, new_models, z = r
            self.reads_done += 1
            pre_z[j] = z
            for p, v in trained.items():
                self.param_collector[p].add(v)
            # skip weird polyA trainings (ref: train.py:226-227)
            polya = "A" * 9 if "A" * 9 in new_models else "A" * 5
            if polya in new_models and new_models[polya][0] < 0.5:
                continue
            for kmer, (m, s) in new_models.items():
                kmer_seen.add(kmer)
                if kmer not in self.param_collector:
                    self.param_collector[kmer] = (ManagedList([m]), ManagedList([s]))
                else:
                    self.param_collector[kmer][0].add(m)
                    self.param_collector[kmer][1].add(s)
        print(f"Zs: {pre_z}", file=sys.stderr)

        self.params_csv.write(f"{epoch},{self.batch_num},{self.reads_done},")
        for p in self.transition_params:
            self.transition_params[p] = self.param_collector[p].mean()
            self.params_csv.write(f"{self.transition_params[p]},")
        for kmer in kmer_seen:
            self.kmer_models[kmer] = (
                self.param_collector[kmer][0].mean(),
                self.param_collector[kmer][1].mean(),
            )
        self.ckpt_path = join(
            self.outdir, f"trained_{epoch}_{self.batch_num}.model"
        )
        write_kmer_models(self.ckpt_path, self.kmer_models)
        self.params_csv.flush()

        post_z = self._post_z(jobs, epoch)
        dz = post_z - pre_z
        print(f"Z changes: {dz}", file=sys.stderr)
        delta = float(np.mean(dz))
        self.params_csv.write(f"{delta}\n")
        self.params_csv.flush()
        return delta

    def close(self):
        self.params_csv.close()
        print("Done training", file=sys.stderr)
