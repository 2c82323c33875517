"""DNA string operations: reverse complement, IUPAC het codes, variant application."""

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


def apply_snp(sequence: str, pos: int, ref: str, alt: str, zygosity: str) -> str:
    """Apply a SNP at 0-based ``pos``: het -> IUPAC code, hom -> alt allele."""
    if zygosity == "het":
        code = het_iupac_code(ref, alt)
    elif zygosity == "hom":
        code = alt
    else:
        raise ValueError(f"zygosity must be het|hom, got {zygosity}")
    return sequence[:pos] + code + sequence[pos + 1 :]
