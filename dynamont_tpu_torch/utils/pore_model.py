"""Pore model (k-mer Gaussian emission table) loading and writing.

A pore model is a TSV `kmer\tlevel_mean\tlevel_stdv` with alphabet_size**kmer_size
rows (ref model format: models/rna/rna002/rna002_5mer.model). Models are stored
in 5'->3' orientation; for RNA pores the k-mers are reversed on load so the
table is indexed in the signal's 3'->5' direction (ref: utils.cpp:301-302).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field

import numpy as np

from dynamont_tpu_torch.utils.kmer import kmer2int, int2kmer


@dataclass(frozen=True)
class PoreModel:
    """Dense k-mer Gaussian table indexed by integer k-mer id.

    means/stdevs are float64 numpy arrays of length K = alphabet_size**kmer_size.
    The arrays are indexed in *processing* orientation (reversed for RNA).
    """

    means: np.ndarray
    stdevs: np.ndarray
    alphabet_size: int
    kmer_size: int
    rna: bool

    @property
    def num_kmers(self) -> int:
        return self.means.shape[0]

    def score_params(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Precomputed per-kmer (mean, c1, c2) so that
        logNormalPdf(x) = c1 - c2 * (x - mean)**2  with
        c1 = -0.5*log(2*pi) - log(sigma), c2 = 0.5 / sigma**2.
        """
        log2pi = 1.8378770664093453
        c1 = -0.5 * log2pi - np.log(self.stdevs)
        c2 = 0.5 / (self.stdevs * self.stdevs)
        return self.means, c1, c2


def _parse_model_tsv(text: str, rna: bool) -> PoreModel:
    lines = text.strip().splitlines()
    header = lines[0].split("\t")
    # tolerate arbitrary extra columns; require kmer/level_mean/level_stdv
    try:
        i_kmer = header.index("kmer")
        i_mean = header.index("level_mean")
        i_std = header.index("level_stdv")
    except ValueError:
        # headerless fall-back: assume kmer, mean, stdv
        i_kmer, i_mean, i_std = 0, 1, 2
        lines.insert(0, "")
    rows = [ln.split("\t") for ln in lines[1:] if ln]
    kmer_size = len(rows[0][i_kmer])
    alphabet = sorted({c for r in rows for c in r[i_kmer]})
    alphabet_size = len(alphabet)
    K = alphabet_size ** kmer_size
    means = np.zeros(K, dtype=np.float64)
    stdevs = np.zeros(K, dtype=np.float64)
    for r in rows:
        kmer = r[i_kmer]
        if len(kmer) != kmer_size:
            raise ValueError(
                f"kmer length mismatch in model: {kmer!r} (expected {kmer_size})"
            )
        if rna:
            kmer = kmer[::-1]  # 5'->3' storage to 3'->5' processing orientation
        idx = kmer2int(kmer, alphabet_size)
        means[idx] = float(r[i_mean])
        stdevs[idx] = float(r[i_std])
    return PoreModel(means, stdevs, alphabet_size, kmer_size, rna)


def load_pore_model(path: str, rna: bool) -> PoreModel:
    """Load a pore model from TSV (.model) or NPZ (.npz)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            means = z["means"].astype(np.float64)
            stdevs = z["stdevs"].astype(np.float64)
            alphabet_size = int(z["alphabet_size"])
            kmer_size = int(z["kmer_size"])
        # npz files are stored in 5'->3' index order; reverse for RNA
        if rna:
            perm = _reverse_permutation(alphabet_size, kmer_size)
            means, stdevs = means[perm], stdevs[perm]
        return PoreModel(means, stdevs, alphabet_size, kmer_size, rna)
    with open(path) as f:
        return _parse_model_tsv(f.read(), rna)


def _reverse_permutation(alphabet_size: int, kmer_size: int) -> np.ndarray:
    """perm[i] = id of the reversed k-mer string of id i."""
    K = alphabet_size ** kmer_size
    ids = np.arange(K)
    out = np.zeros(K, dtype=np.int64)
    q = ids.copy()
    for pos in range(kmer_size):
        digit = q % alphabet_size
        out = out * alphabet_size + digit
        q //= alphabet_size
    return out


def save_pore_model_npz(path: str, model: PoreModel) -> None:
    """Save in canonical 5'->3' index order."""
    means, stdevs = model.means, model.stdevs
    if model.rna:
        perm = _reverse_permutation(model.alphabet_size, model.kmer_size)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        means, stdevs = means[inv], stdevs[inv]
    np.savez(
        path,
        means=means,
        stdevs=stdevs,
        alphabet_size=model.alphabet_size,
        kmer_size=model.kmer_size,
    )


# --- dict-style helpers matching the reference Python API -------------------
# (ref: FileIO.py:86-109 readKmerModels/writeKmerModels)

def read_kmer_models(path: str) -> dict[str, tuple[float, float]]:
    """{kmer(5'->3') : (mean, stdev)} straight from a TSV (no reorientation)
    or from a packaged .npz (stored in 5'->3' index order), so the trainer
    accepts the packaged default models as initial values."""
    if path.endswith(".npz"):
        from dynamont_tpu_torch.utils.kmer import int2kmers_batch

        with np.load(path) as z:
            means = z["means"].astype(np.float64)
            stdevs = z["stdevs"].astype(np.float64)
            alphabet_size = int(z["alphabet_size"])
            kmer_size = int(z["kmer_size"])
        kmers = int2kmers_batch(np.arange(len(means)), alphabet_size,
                                kmer_size, rna=False)
        return {k: (float(m), float(s))
                for k, m, s in zip(kmers, means, stdevs)}
    models: dict[str, tuple[float, float]] = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        i_kmer, i_mean, i_std = header.index("kmer"), header.index("level_mean"), header.index("level_stdv")
        for ln in f:
            if not ln.strip():
                continue
            r = ln.rstrip("\n").split("\t")
            models[r[i_kmer]] = (float(r[i_mean]), float(r[i_std]))
    return models


def write_kmer_models(path: str, models: dict[str, tuple[float, float]]) -> None:
    with open(path, "w") as w:
        w.write("kmer\tlevel_mean\tlevel_stdv\n")
        for kmer, (mean, stdev) in models.items():
            w.write(f"{kmer}\t{mean}\t{stdev}\n")


def pore_model_from_dict(models: dict[str, tuple[float, float]], rna: bool) -> PoreModel:
    buf = io.StringIO()
    buf.write("kmer\tlevel_mean\tlevel_stdv\n")
    for kmer, (mean, stdev) in models.items():
        buf.write(f"{kmer}\t{mean}\t{stdev}\n")
    return _parse_model_tsv(buf.getvalue(), rna)


def reduce_cli(argv=None) -> None:
    """CLI for the 9-mer -> 5-mer model reduction (ref: models/9merTo5mer.py)."""
    from argparse import ArgumentParser

    p = ArgumentParser(prog="dynamont-9mer-to-5mer")
    p.add_argument("-i", "--input", required=True, help="9-mer model TSV")
    p.add_argument("-o", "--output", required=True, help="5-mer model TSV")
    args = p.parse_args(argv)
    write_kmer_models(args.output, reduce_9mer_to_5mer(read_kmer_models(args.input)))


def reduce_model_to_5mer(model: PoreModel) -> PoreModel:
    """In-memory 9-mer -> 5-mer reduction of a loaded PoreModel (same math
    as the TSV-level reduce_9mer_to_5mer; ref: models/9merTo5mer.py:6-50).

    Used as the documented NTC fallback for 9-mer pores: the NTC TK
    pre-pass is dense over K = 4^kmer_size columns (ref:
    NTC_main.cpp:95-99), which is impractical at K=262144 for
    production-length reads — the reference project itself ships reduced
    5-mer tables (models/rna/rna004/rna004_5mer.model) for this reason.
    """
    from dynamont_tpu_torch.utils.kmer import int2kmer

    if model.kmer_size <= 5:
        return model
    d = {
        int2kmer(k, model.alphabet_size, model.kmer_size, model.rna):
            (float(model.means[k]), float(model.stdevs[k]))
        for k in range(model.num_kmers)
    }
    return pore_model_from_dict(reduce_9mer_to_5mer(d), model.rna)


def reduce_9mer_to_5mer(models9: dict[str, tuple[float, float]]) -> dict[str, tuple[float, float]]:
    """Average 9-mer Gaussians over the middle 5 bases -> 5-mer model.

    Port of the reference's models/9merTo5mer.py reduction: for each 5-mer,
    average mean/stdev over all 9-mers whose positions 2..6 equal the 5-mer.
    """
    acc: dict[str, list[list[float]]] = {}
    for kmer, (mean, std) in models9.items():
        mid = kmer[2:7]
        acc.setdefault(mid, [[], []])
        acc[mid][0].append(mean)
        acc[mid][1].append(std)
    return {k: (float(np.mean(v[0])), float(np.mean(v[1]))) for k, v in acc.items()}
