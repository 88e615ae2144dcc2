"""Global constants: default transition tables, base codecs, numeric tolerances.

The per-pore default transition probabilities are *trained parameter values*
taken from the reference implementation (rnajena/dynamont, src/cpp/utils.cpp:10-110);
they are data, required for output parity, not code.
"""

from __future__ import annotations

# Numeric error tolerance for the forward/backward Z consistency invariant.
# The check is  abs(Zf - Zb) / n_cells <= EPSILON  (ref: utils.cpp:7, NT_main.cpp:146).
EPSILON = 1e-8

# Nucleotide <-> token maps (ref: utils.cpp:112-130). U maps to T; N is allowed
# as a 5th symbol but never appears in 4-letter pore models.
BASE2ID = {
    "A": 0, "a": 0,
    "C": 1, "c": 1,
    "G": 2, "g": 2,
    "T": 3, "t": 3,
    "U": 3, "u": 3,
    "N": 4, "n": 4,
}
ID2BASE = {0: "A", 1: "C", 2: "G", 3: "T", 4: "N"}

PORES = ("rna002", "dna_r9", "rna004", "dna_r10_260bps", "dna_r10_400bps")

# kmer length per pore type (ref: segment.py:308)
PORE_KMER_SIZE = {
    "rna002": 5,
    "dna_r9": 5,
    "rna004": 9,
    "dna_r10_260bps": 9,
    "dna_r10_400bps": 9,
}

RNA_PORES = ("rna002", "rna004")


def is_rna(pore: str) -> bool:
    return "rna" in pore


# ---------------------------------------------------------------------------
# Default NT (2-state) transition probabilities, per pore.
# ref: utils.cpp:86-110
# ---------------------------------------------------------------------------
NT_TRANSITIONS = {
    "rna002": {"m1": 0.019889650396799997, "e1": 1.0, "e2": 0.9801103496029998},
    "rna004": {"m1": 0.031111753637096777, "e1": 1.0, "e2": 0.9688882463622581},
    "dna_r9": {"m1": 1.0, "e1": 1.0, "e2": 1.0},
    # reference marks r10 entries "TODO train; so far using the same values as rp4"
    "dna_r10_260bps": {"m1": 0.031111753637096777, "e1": 1.0, "e2": 0.9688882463622581},
    "dna_r10_400bps": {"m1": 0.031111753637096777, "e1": 1.0, "e2": 0.9688882463622581},
}

# ---------------------------------------------------------------------------
# Default NTC/NTK (5-state 3D) transition probabilities, per pore.
# ref: utils.cpp:10-84
# ---------------------------------------------------------------------------
NTK_PARAM_NAMES = (
    "a1", "a2", "p1", "p2", "p3", "s1", "s2", "s3",
    "e1", "e2", "e3", "e4", "i1", "i2",
)

NTK_TRANSITIONS = {
    "rna002": {
        "a1": 0.019326040280789637,
        "a2": 0.19725479693713352,
        "p1": 0.1979799841413514,
        "p2": 0.0006135538271005425,
        "p3": 0.7669801909288386,
        "s1": 0.27034500789657623,
        "s2": 0.00032463686748883153,
        "s3": 0.02916688206070035,
        "e1": 1.0,
        "e2": 0.7296549921055607,
        "e3": 0.8020200158564497,
        "e4": 0.9797333838008437,
        "i1": 2.3852272324574183e-06,
        "i2": 0.006598130068516047,
    },
    "rna004": {
        "a1": 0.029709838889618322,
        "a2": 0.2837864344979079,
        "p1": 0.15353628902814298,
        "p2": 0.0041495012884881655,
        "p3": 0.47456322874771467,
        "s1": 0.05012685122100474,
        "s2": 0.0006112333189296363,
        "s3": 0.13506593503589423,
        "e1": 1.0,
        "e2": 0.949873148779652,
        "e3": 0.8464637109688202,
        "e4": 0.9654529072452087,
        "i1": 7.651926003806137e-05,
        "i2": 0.10658440170772512,
    },
    "dna_r9": {name: 1.0 for name in NTK_PARAM_NAMES},
}
# reference uses the rna004 values for both r10 pores ("TODO train")
NTK_TRANSITIONS["dna_r10_260bps"] = dict(NTK_TRANSITIONS["rna004"])
NTK_TRANSITIONS["dna_r10_400bps"] = dict(NTK_TRANSITIONS["rna004"])

# Initial transition params used by dynamont-train for fresh training runs
# (ref: train.py:79-101)
TRAIN_INIT_NT = {"e1": 1.0, "m1": 0.03, "e2": 0.97}
TRAIN_INIT_NTK = {
    "a1": 0.012252440188168037,
    "a2": 0.246584724985145,
    "p1": 0.04477093133243305,
    "p2": 0.007687811003133089,
    "p3": 0.4469623669791557,
    "s1": 0.05321209670114726,
    "s2": 0.0007555035568187239,
    "s3": 0.21999557711272136,
    "e1": 1.0,
    "e2": 0.9467879033992115,
    "e3": 0.9552290685034269,
    "e4": 0.9792321612614708,
    "i1": 7.208408117990252e-05,
    "i2": 0.08645733058947891,
}


def resolve_transitions(defaults: dict, overrides: dict | None = None) -> dict:
    """Merge user overrides with per-pore defaults, sentinel -1 = use default.

    Mirrors updateTransitions (ref: utils.cpp:409-423): a value of -1 selects
    the trained per-pore default; anything else is taken verbatim. Returns
    *probabilities* (log is applied by the DP layers).
    """
    out = dict(defaults)
    if overrides:
        for k, v in overrides.items():
            if v is None or v == -1.0:
                continue
            if k not in out:
                raise KeyError(f"unknown transition parameter {k!r}")
            out[k] = float(v)
    return out
