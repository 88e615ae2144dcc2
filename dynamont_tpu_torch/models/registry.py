"""Per-pore pore-model registry (ref: FileIO.py:521-542 getModel)."""

from __future__ import annotations

import os

from dynamont_tpu_torch.constants import is_rna
from dynamont_tpu_torch.utils.pore_model import PoreModel, load_pore_model

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "models_data")

# default packaged model per pore; the 9-mer RNA004 and DNA r10.4.1 tables are
# not redistributable in this build — users pass --model_path for those, or the
# 5-mer reduction is used (see utils.pore_model.reduce_9mer_to_5mer).
_DEFAULTS = {
    "rna002": "rna002_5mer.npz",
    "dna_r9": None,
    "rna004": "rna004_9mer.npz",
    "dna_r10_260bps": "dna_r10.4.1_e8.2_260bps.npz",
    "dna_r10_400bps": "dna_r10.4.1_e8.2_400bps.npz",
}

_FALLBACKS = {
    "rna004": "rna004_5mer.npz",
}


def get_model_path(pore: str) -> str:
    """Path of the packaged default model for a pore type."""
    name = _DEFAULTS.get(pore)
    candidates = [name] if name else []
    if pore in _FALLBACKS:
        candidates.append(_FALLBACKS[pore])
    for cand in candidates:
        path = os.path.abspath(os.path.join(_DATA_DIR, cand))
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"no packaged pore model for {pore!r}; pass an explicit --model_path "
        f"(TSV kmer\\tlevel_mean\\tlevel_stdv or .npz)"
    )


def load_model_for_pore(pore: str, model_path: str | None = None) -> PoreModel:
    path = model_path or get_model_path(pore)
    return load_pore_model(path, rna=is_rna(pore))
