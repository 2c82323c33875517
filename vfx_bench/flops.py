"""The yardstick's arithmetic: matmul FLOPs of the seq2gene model, the least
time its work can take on one H100, and the table of peaks.

``seq2gene_flops`` and its stage functions are a frozen copy of the port's
``utils/flops.py`` (every matmul/einsum contraction as 2*M*N*K; elementwise,
softmax and norm work left out); ``tests/test_bench_flops.py`` holds the two
equal. ``batch_flops`` sums the same terms over a batch's REAL genes: each
gene's own CRE and gene-window counts and each window's own token count, so
padding the program adds is not counted as work.

``least_time`` is the denominator-free side of ``kernels_roofline.*``: for
every matmul, attention, LayerNorm, GeGLU, pooling and (training) Adam
operation the step needs, max(operations / the peak for its type, bytes /
the memory bandwidth), summed; ``least_counters`` also splits the same sum
by the program's stages, the side of each ``<stage>_roofline.*``. Bytes
count each input read once and each output written once, whatever a kernel
re-reads; activations in the compute dtype (bf16), weight gradients and
optimizer state in f32. The count does not depend on which kernels
implement the work.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense (no sparsity), at 700 W.
PEAKS = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "fp8_flops": 1979e12,
    "hbm_bytes": 3.35e12,
}


# -- the copy of utils/flops.py ---------------------------------------------
def _attn_flops(b: int, sq: int, sk: int, e: int) -> float:
    return 4.0 * b * sq * sk * e


def window_encoder_flops(cfg: dict, n_windows: int) -> float:
    w = cfg["window_encoder"]
    e, l, f = w["embedding_dim"], w["token_length"], w["ffn_hidden_dim"]
    per_layer = (
        2.0 * n_windows * l * e * (3 * e)
        + _attn_flops(n_windows, l, l, e)
        + 2.0 * n_windows * l * e * e
        + 2.0 * n_windows * l * e * f
        + 2.0 * n_windows * l * (f // 2) * e
    )
    return per_layer * w["num_layers"]


def cre_stack_flops(cfg: dict, d: int, c: int) -> float:
    m = cfg["seq2gene"]
    e, f = m["emb_dim"], m["ffn_hidden_dim"]
    per_layer = (
        2.0 * d * c * e * (3 * e)
        + _attn_flops(d, c, c, e)
        + 2.0 * d * c * e * e
        + 2.0 * d * c * e * e
        + 2.0 * d * c * e * (2 * e)
        + _attn_flops(d, c, c, e)
        + 2.0 * d * c * e * e
        + 2.0 * d * c * e * f
        + 2.0 * d * c * (f // 2) * e
    )
    return per_layer * (m["num_layers"] - 1)


def gene_stack_flops(cfg: dict, d: int, c: int, g1: int, t: int) -> float:
    m = cfg["seq2gene"]
    e, f = m["emb_dim"], m["ffn_hidden_dim"]
    dt = d * t
    per_layer = (
        2.0 * dt * g1 * e * (3 * e)
        + _attn_flops(dt, g1, g1, e)
        + 2.0 * dt * g1 * e * e
        + 2.0 * dt * g1 * e * e
        + 2.0 * d * c * e * (2 * e)
        + _attn_flops(dt, g1, c, e)
        + 2.0 * dt * g1 * e * e
        + 2.0 * dt * g1 * e * f
        + 2.0 * dt * g1 * (f // 2) * e
    )
    if m["only_cross_attention"]:
        per_layer -= (
            2.0 * dt * g1 * e * (3 * e)
            + _attn_flops(dt, g1, g1, e)
            + 2.0 * dt * g1 * e * e
        )
    return per_layer * m["num_layers"]


def tissue_head_flops(cfg: dict, d: int, t: int) -> float:
    e = cfg["seq2gene"]["emb_dim"]
    return 2.0 * d * t * (e * e + e * e + e)


def seq2gene_flops(cfg: dict, d: int, c: int, g: int, t: int) -> dict[str, float]:
    m = cfg["seq2gene"]
    e = m["emb_dim"]
    enc = window_encoder_flops(cfg, d * (c + g))
    maps = 2.0 * d * c * m["token_dim"] * e + 2.0 * d * g * m["gene_emb_dim"] * e
    cre = cre_stack_flops(cfg, d, c)
    gene = gene_stack_flops(cfg, d, c, g + 1, t)
    heads = tissue_head_flops(cfg, d, t)
    return {"window_encoder": enc, "width_maps": maps, "cre_stack": cre, "gene_stack": gene,
            "tissue_heads": heads, "total": enc + maps + cre + gene + heads}


# -- real shapes ------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GeneShape:
    """One real gene of a batch: its windows' token counts and its tissues."""

    cre_tokens: tuple[int, ...]   # valid tokens of each CRE window
    gene_tokens: tuple[int, ...]  # valid tokens of each gene window
    tissues: int

    @property
    def c(self) -> int:
        return len(self.cre_tokens)

    @property
    def g(self) -> int:
        return len(self.gene_tokens)


def _windows_flops(cfg: dict, tokens) -> float:
    """The encoder's FLOPs over windows of the given token counts."""
    w = cfg["window_encoder"]
    e, f = w["embedding_dim"], w["ffn_hidden_dim"]
    n = float(sum(tokens))
    sq = float(sum(x * x for x in tokens))
    per_layer = 2.0 * n * e * (3 * e + e + f + f // 2) + 4.0 * sq * e
    return per_layer * w["num_layers"]


def batch_flops(cfg: dict, genes: list[GeneShape]) -> dict[str, float]:
    """``seq2gene_flops`` summed over real genes (each its own C, G and
    window token counts). Equals ``seq2gene_flops`` for full windows."""
    m = cfg["seq2gene"]
    e = m["emb_dim"]
    out = dict.fromkeys(("cre_tokenizer", "gene_tokenizer", "width_maps", "cre_stack",
                         "gene_stack", "tissue_heads"), 0.0)
    for s in genes:
        out["cre_tokenizer"] += _windows_flops(cfg, s.cre_tokens)
        out["gene_tokenizer"] += _windows_flops(cfg, s.gene_tokens)
        out["width_maps"] += 2.0 * s.c * m["token_dim"] * e + 2.0 * s.g * m["gene_emb_dim"] * e
        out["cre_stack"] += cre_stack_flops(cfg, 1, s.c)
        out["gene_stack"] += gene_stack_flops(cfg, 1, s.c, s.g + 1, s.tissues)
        out["tissue_heads"] += tissue_head_flops(cfg, 1, s.tissues)
    out["total"] = sum(out.values())
    return out


def train_flops(cfg: dict, genes: list[GeneShape], frozen=("cre_tokenizer",)) -> float:
    """Forward + 2x forward (the backward) of every trained part; a frozen
    part counts its forward only; recomputation is not counted."""
    f = batch_flops(cfg, genes)
    return 3.0 * f["total"] - 2.0 * sum(f[k] for k in frozen)


# -- least time ---------------------------------------------------------------
STAGES = ("window_encoder", "maps", "cre_stack", "gene_stack", "heads", "optimizer")


class LeastTime:
    """Accumulates max(ops / peak, bytes / bandwidth) over operations, in
    all and by the stage that ``stage`` last named."""

    def __init__(self, act_bytes: int = 2, peaks: dict = PEAKS):
        self.a = act_bytes
        self.peaks = peaks
        self.seconds = 0.0
        self.by_stage = dict.fromkeys(STAGES, 0.0)
        self.stage = STAGES[0]

    def op(self, flops: float, nbytes: float, peak: str = "bf16_flops") -> None:
        s = max(flops / self.peaks[peak], nbytes / self.peaks["hbm_bytes"])
        self.seconds += s
        self.by_stage[self.stage] += s

    def linear(self, m: float, k: int, n: int, backward: bool = False) -> None:
        a = self.a
        self.op(2.0 * m * k * n, a * (m * k + k * n + m * n))
        if backward:
            self.op(2.0 * m * k * n, a * (m * n + k * n + m * k))      # dX = dY W^T
            self.op(2.0 * m * k * n, a * (m * k + m * n) + 4 * k * n)  # dW = X^T dY, f32

    def attention(self, pairs: float, q_rows: float, kv_rows: float, e: int,
                  backward: bool = False) -> None:
        """``pairs`` = sum of Sq*Sk over the items; rows of q/o and k/v."""
        a = self.a
        self.op(4.0 * pairs * e, a * e * (2 * q_rows + 2 * kv_rows))
        if backward:
            self.op(8.0 * pairs * e, a * e * (3 * q_rows + 2 * kv_rows + q_rows + 2 * kv_rows))

    def rowwise(self, rows: float, width_in: int, width_out: int,
                backward: bool = False) -> None:
        """LayerNorm (in = out) or GeGLU (out = in / 2): bytes only."""
        a = self.a
        self.op(0.0, a * rows * (width_in + width_out))
        if backward:
            self.op(0.0, a * rows * (width_in + 2 * width_out))

    def pool(self, windows: float, tokens: float, e: int, backward: bool = False) -> None:
        self.op(0.0, self.a * e * (tokens + windows))
        if backward:
            self.op(0.0, self.a * e * (tokens + windows))

    def adam(self, n_params: float) -> None:
        self.op(10.0 * n_params, 28.0 * n_params, peak="fp32_flops")


def _layer(lt: LeastTime, rows: float, e: int, f: int, self_pairs: float,
           cross_q_rows: float, cross_pairs: float, cross_kv_rows: float,
           kv_rows_proj: float, bwd: bool) -> None:
    """One pre-LN layer: LN, QKV, self-attention, out-proj (self part, when
    ``self_pairs``), LN, Q, the K/V projection of ``kv_rows_proj`` context
    rows, cross-attention, out-proj (cross part, when ``cross_pairs``),
    LN, GeGLU FFN."""
    if self_pairs:
        lt.rowwise(rows, e, e, bwd)
        lt.linear(rows, e, 3 * e, bwd)
        lt.attention(self_pairs, rows, rows, e, bwd)
        lt.linear(rows, e, e, bwd)
    if cross_pairs:
        lt.rowwise(cross_q_rows, e, e, bwd)
        lt.linear(cross_q_rows, e, e, bwd)
        lt.linear(kv_rows_proj, e, 2 * e, bwd)
        lt.attention(cross_pairs, cross_q_rows, cross_kv_rows, e, bwd)
        lt.linear(cross_q_rows, e, e, bwd)
    lt.rowwise(rows, e, e, bwd)
    lt.linear(rows, e, f, bwd)
    lt.rowwise(rows, f, f // 2, bwd)
    lt.linear(rows, f // 2, e, bwd)


def _least_time(cfg: dict, genes: list[GeneShape], train: bool = False,
                trained_params: float = 0.0, frozen=("cre_tokenizer",)) -> LeastTime:
    w, m = cfg["window_encoder"], cfg["seq2gene"]
    e1, f1, e, f = w["embedding_dim"], w["ffn_hidden_dim"], m["emb_dim"], m["ffn_hidden_dim"]
    lt = LeastTime()
    lt.stage = "window_encoder"
    for name, toks in (("cre_tokenizer", [x for s in genes for x in s.cre_tokens]),
                       ("gene_tokenizer", [x for s in genes for x in s.gene_tokens])):
        bwd = train and name not in frozen
        rows = float(sum(toks))
        pairs = float(sum(x * x for x in toks))
        for _ in range(w["num_layers"]):
            _layer(lt, rows, e1, f1, pairs, 0, 0, 0, 0, bwd)
        lt.pool(len(toks), rows, e1, bwd)
    lt.stage = "maps"
    c_rows = float(sum(s.c for s in genes))
    g_rows = float(sum(s.g for s in genes))
    lt.linear(c_rows, m["token_dim"], e, train)
    lt.linear(g_rows, m["gene_emb_dim"], e, train)
    lt.stage = "cre_stack"
    c_pairs = float(sum(s.c * s.c for s in genes))
    for _ in range(m["num_layers"] - 1):
        _layer(lt, c_rows, e, f, c_pairs, c_rows, c_pairs, c_rows, c_rows, train)
    lt.stage = "gene_stack"
    q_rows = float(sum(s.tissues * (s.g + 1) for s in genes))
    self_pairs = float(sum(s.tissues * (s.g + 1) ** 2 for s in genes))
    cross_pairs = float(sum(s.tissues * (s.g + 1) * s.c for s in genes))
    for _ in range(m["num_layers"]):
        _layer(lt, q_rows, e, f, self_pairs, q_rows, cross_pairs, c_rows, c_rows, train)
    lt.stage = "heads"
    head_rows = float(sum(s.tissues for s in genes))
    lt.linear(head_rows, e, e, train)
    lt.rowwise(head_rows, e, e, train)
    lt.linear(head_rows, e, e, train)
    lt.linear(head_rows, e, 1, train)
    if train:
        lt.stage = "optimizer"
        lt.adam(trained_params)
    return lt


def least_time(cfg: dict, genes: list[GeneShape], train: bool = False,
               trained_params: float = 0.0, frozen=("cre_tokenizer",)) -> float:
    """Seconds the batch's forward (and with ``train`` its backward and one
    Adam update of ``trained_params`` f32 values) takes at least, summed
    over the batch's real genes (rows of one operation are one operation:
    weights are counted once per batch)."""
    return _least_time(cfg, genes, train, trained_params, frozen).seconds


def least_counters(cfg: dict, batches: list[list[GeneShape]], **kw) -> dict:
    """A traced window's least time as counters: ``trace_least_s``
    (``least_time`` summed over its batches) and ``trace_least_s.<stage>``,
    its part in each of ``STAGES``: both window sets with their pools, the
    width maps, the CRE stack, the gene stack with its K/V projections of
    the CRE rows, the tissue heads (the port's ``seq2gene.*`` spans), each
    with its backward under ``train``, and the optimizer's update."""
    lts = [_least_time(cfg, b, **kw) for b in batches]
    out = {"trace_least_s": sum(lt.seconds for lt in lts)}
    out.update({f"trace_least_s.{s}": sum(lt.by_stage[s] for lt in lts) for s in STAGES})
    return out
