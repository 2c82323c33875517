"""Analytic matmul-FLOP counter for the seq2gene forward pass.

The port of ``variantformer_tpu/utils/flops.py``, the same arithmetic on
the port's ``config.ModelConfig``: every matmul/einsum contraction of the
forward counted as 2*M*N*K, ignoring elementwise, softmax and norm work
(<5% of the total at model shapes). It is the numerator of a whole-forward
FLOP share (``bench.py`` of the port, ``chip_smoke.py``): a device profile
cannot count inside the hand-written kernels.

Stage map (matches models/seq2gene.seq2gene_forward):
  window encoder  — reference seq2reg windowed_tformer_model.py forward
  CRE stack       — reference model_combined_modulator.py:137-200
  gene stack      — reference model_combined_modulator.py:201-328
  tissue heads    — reference seq2gene/modules/layers.py:1060-1144
"""

from __future__ import annotations

from variantformer_tpu_torch.config import ModelConfig


def _attn_flops(b: int, sq: int, sk: int, e: int) -> float:
    """Scores + PV for all heads at model width e: 2 * (2*Sq*Sk*E) per item."""
    return 4.0 * b * sq * sk * e


def window_encoder_flops(cfg: ModelConfig, n_windows: int) -> float:
    """Plain (use_context=False) encoder: QKV+out, per-window self-attn, GeGLU."""
    w = cfg.window_encoder
    e, l, f = w.embedding_dim, w.token_length, w.ffn_hidden_dim
    per_layer = (
        2.0 * n_windows * l * e * (3 * e)          # QKV
        + _attn_flops(n_windows, l, l, e)          # scores + PV
        + 2.0 * n_windows * l * e * e              # out projection
        + 2.0 * n_windows * l * e * f              # GeGLU in
        + 2.0 * n_windows * l * (f // 2) * e       # GeGLU out
    )
    return per_layer * w.num_layers


def cre_stack_flops(cfg: ModelConfig, d: int, c: int) -> float:
    """(num_layers-1) context-encoder layers on the [D, C, E] CRE stream."""
    m = cfg.seq2gene
    e, f = m.emb_dim, m.ffn_hidden_dim
    per_layer = (
        2.0 * d * c * e * (3 * e)                  # self QKV
        + _attn_flops(d, c, c, e)                  # self scores + PV
        + 2.0 * d * c * e * e                      # self out
        + 2.0 * d * c * e * e                      # cross Q
        + 2.0 * d * c * e * (2 * e)                # cross KV (class context)
        + _attn_flops(d, c, c, e)                  # cross scores + PV
        + 2.0 * d * c * e * e                      # cross out
        + 2.0 * d * c * e * f                      # GeGLU in
        + 2.0 * d * c * (f // 2) * e               # GeGLU out
    )
    return per_layer * (m.num_layers - 1)


def gene_stack_flops(cfg: ModelConfig, d: int, c: int, g1: int, t: int) -> float:
    """num_layers gene layers on the [D, T, G1, E] stream; cross K/V are
    projected once per donor (shared over tissues), as the forward does."""
    m = cfg.seq2gene
    e, f = m.emb_dim, m.ffn_hidden_dim
    dt = d * t
    per_layer = (
        2.0 * dt * g1 * e * (3 * e)                # self QKV
        + _attn_flops(dt, g1, g1, e)               # self scores + PV
        + 2.0 * dt * g1 * e * e                    # self out
        + 2.0 * dt * g1 * e * e                    # cross Q
        + 2.0 * d * c * e * (2 * e)                # cross KV, donor-shared
        + _attn_flops(dt, g1, c, e)                # cross scores + PV
        + 2.0 * dt * g1 * e * e                    # cross out
        + 2.0 * dt * g1 * e * f                    # GeGLU in
        + 2.0 * dt * g1 * (f // 2) * e             # GeGLU out
    )
    if m.only_cross_attention:
        per_layer -= (
            2.0 * dt * g1 * e * (3 * e)
            + _attn_flops(dt, g1, g1, e)
            + 2.0 * dt * g1 * e * e
        )
    return per_layer * m.num_layers


def tissue_head_flops(cfg: ModelConfig, d: int, t: int) -> float:
    e = cfg.seq2gene.emb_dim
    return 2.0 * d * t * (e * e + e * e + e)


def seq2gene_flops(
    cfg: ModelConfig, d: int, c: int, g: int, t: int
) -> dict[str, float]:
    """Matmul FLOPs of one seq2gene forward, by stage + total.

    d donors, c CRE windows, g gene windows (registry token adds one row to
    the gene stream), t tissues.
    """
    m = cfg.seq2gene
    e = m.emb_dim
    enc = window_encoder_flops(cfg, d * (c + g))
    maps = (
        2.0 * d * c * m.token_dim * e + 2.0 * d * g * m.gene_emb_dim * e
    )
    cre = cre_stack_flops(cfg, d, c)
    gene = gene_stack_flops(cfg, d, c, g + 1, t)
    heads = tissue_head_flops(cfg, d, t)
    total = enc + maps + cre + gene + heads
    return {
        "window_encoder": enc,
        "width_maps": maps,
        "cre_stack": cre,
        "gene_stack": gene,
        "tissue_heads": heads,
        "total": total,
    }
