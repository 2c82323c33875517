"""Genome alphabet, cCRE class spaces, and tokenizer specials.

The part of ``variantformer_tpu/utils/constants.py`` the vcf2exp path reads:
the IUPAC code table deliberately excludes N (N splits sequences during
tokenization), only autosomes are supported, and the 9-class reference-cCRE
label space indexes the context embeddings of both model stages.
"""

from __future__ import annotations

# IUPAC nucleotide codes -> the set of bases they stand for. N is intentionally
# absent: any non-IUPAC character acts as a hard split point in tokenization.
IUPAC_CODES: dict[str, tuple[str, ...]] = {
    "A": ("A",),
    "C": ("C",),
    "G": ("G",),
    "T": ("T",),
    "R": ("A", "G"),
    "Y": ("C", "T"),
    "S": ("G", "C"),
    "W": ("A", "T"),
    "K": ("G", "T"),
    "M": ("A", "C"),
    "B": ("C", "G", "T"),
    "D": ("A", "G", "T"),
    "H": ("A", "C", "T"),
    "V": ("A", "C", "G"),
}

# Unordered base-pair -> IUPAC ambiguity code (used to encode heterozygous sites).
HET_IUPAC: dict[str, str] = {
    "AA": "A", "CC": "C", "GG": "G", "TT": "T",
    "AC": "M", "CA": "M",
    "AG": "R", "GA": "R",
    "AT": "W", "TA": "W",
    "CG": "S", "GC": "S",
    "CT": "Y", "TC": "Y",
    "GT": "K", "TG": "K",
}

# Complement map over the full IUPAC alphabet (upper+lower case), plus gap chars.
COMPLEMENT: dict[str, str] = {}
for _f, _t in [
    ("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"),
    ("R", "Y"), ("Y", "R"), ("S", "S"), ("W", "W"),
    ("K", "M"), ("M", "K"), ("B", "V"), ("D", "H"),
    ("H", "D"), ("V", "B"), ("N", "N"),
]:
    COMPLEMENT[_f] = _t
    COMPLEMENT[_f.lower()] = _t.lower()
COMPLEMENT["-"] = "-"
COMPLEMENT["."] = "."

IGNORE_CHRS = ("chrX", "chrY", "chrM")
AUTOSOMES = tuple(f"chr{i}" for i in range(1, 23))

# ENCODE reference cCRE classes (9-way) — index space of the context embeddings.
REF_CRES = (
    "CTCF-only,CTCF-bound",
    "DNase-H3K4me3",
    "DNase-H3K4me3,CTCF-bound",
    "PLS",
    "PLS,CTCF-bound",
    "dELS",
    "dELS,CTCF-bound",
    "pELS",
    "pELS,CTCF-bound",
)
MAP_REF_CRE_TO_IDX = {name: i for i, name in enumerate(REF_CRES)}

# 11-class cCRE label space of the window-encoder classifier heads.
CRES = (
    "Low-DNase",
    "DNase-only",
    "CTCF-only,CTCF-bound",
    "DNase-H3K4me3",
    "DNase-H3K4me3,CTCF-bound",
    "PLS",
    "PLS,CTCF-bound",
    "dELS",
    "dELS,CTCF-bound",
    "pELS",
    "pELS,CTCF-bound",
)
MAP_CRE_TO_IDX = {name: i for i, name in enumerate(CRES)}

# Tokenizer special tokens (ids 0-3 in the released BPE vocabulary).
SPECIAL_TOKENS = {
    "pad_token": "<pad>",
    "bos_token": "<s>",
    "eos_token": "</s>",
    "unk_token": "<unk>",
}
