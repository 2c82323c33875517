"""DNA string operations: reverse complement and IUPAC het codes."""

from __future__ import annotations

from variantformer_tpu_torch.utils.constants import COMPLEMENT, HET_IUPAC

_COMP_TABLE = str.maketrans(COMPLEMENT)


def reverse_complement(sequence: str) -> str:
    """Reverse complement over the full IUPAC alphabet (case-preserving);
    unknown characters pass through unchanged."""
    return sequence[::-1].translate(_COMP_TABLE)


def het_iupac_code(ref: str, alt: str) -> str:
    """IUPAC ambiguity code for a heterozygous SNP; 'N' if not a base pair."""
    return HET_IUPAC.get(ref.upper() + alt.upper(), "N")
