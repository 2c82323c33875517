"""The yardstick's arithmetic: the FLOP copy against the port's
``utils/flops.py``, the real-shape sums, and the least time of one forward
worked out by hand."""

import json

import pytest

from vfx_bench import flops, harness

CFG = json.loads((harness.HERE / "configs" / "v4_pcg.json").read_text())


@pytest.mark.parametrize("d,c,g,t", [(4, 384, 200, 54), (1, 90, 200, 54), (2, 16, 37, 1),
                                     (8, 1024, 200, 63), (3, 1, 1, 2)])
def test_copy_equals_the_ports(d, c, g, t):
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.utils.flops import seq2gene_flops

    port = seq2gene_flops(ModelConfig(), d, c, g, t)
    mine = flops.seq2gene_flops(CFG, d, c, g, t)
    assert port == mine


@pytest.mark.parametrize("d,c,g,t", [(4, 384, 200, 54), (2, 90, 120, 3)])
def test_full_windows_sum_to_the_copy(d, c, g, t):
    genes = [flops.GeneShape((200,) * c, (200,) * g, t)] * d
    f = flops.batch_flops(CFG, genes)
    ref = flops.seq2gene_flops(CFG, d, c, g, t)
    assert f["total"] == pytest.approx(ref["total"], rel=1e-12)
    assert f["cre_tokenizer"] + f["gene_tokenizer"] == pytest.approx(ref["window_encoder"])


def test_train_flops_counts_the_frozen_tokenizer_once():
    genes = [flops.GeneShape((70,) * 90, (200,) * 200, 54)]
    f = flops.batch_flops(CFG, genes)
    assert flops.train_flops(CFG, genes) == pytest.approx(3 * f["total"] - 2 * f["cre_tokenizer"])


def test_least_time_of_one_forward_by_hand():
    """A narrow model, one gene: every operation's max(ops / 989e12,
    bytes / 3.35e12) summed by hand."""
    cfg = {"window_encoder": {"embedding_dim": 8, "ffn_hidden_dim": 16, "num_layers": 1},
           "seq2gene": {"emb_dim": 8, "ffn_hidden_dim": 16, "num_layers": 2, "token_dim": 8,
                        "gene_emb_dim": 8}}
    gene = flops.GeneShape((3,), (2,), 1)
    P, B = 989e12, 3.35e12

    def t(ops, nbytes):
        return max(ops / P, nbytes / B)

    def lin(m, k, n):
        return t(2 * m * k * n, 2 * (m * k + k * n + m * n))

    def layer(rows, e, f, pairs, q_rows=0, c_pairs=0, kv_rows=0, kv_proj=0):
        s = 0.0
        if pairs:
            s += t(0, 2 * rows * 2 * e) + lin(rows, e, 3 * e)
            s += t(4 * pairs * e, 2 * e * 4 * rows) + lin(rows, e, e)
        if c_pairs:
            s += t(0, 2 * q_rows * 2 * e) + lin(q_rows, e, e) + lin(kv_proj, e, 2 * e)
            s += t(4 * c_pairs * e, 2 * e * (2 * q_rows + 2 * kv_rows)) + lin(q_rows, e, e)
        s += t(0, 2 * rows * 2 * e) + lin(rows, e, f) + t(0, 2 * rows * (f + f // 2))
        return s + lin(rows, f // 2, e)

    want = layer(3, 8, 16, 9) + t(0, 2 * 8 * (3 + 1))          # CRE window + pool
    want += layer(2, 8, 16, 4) + t(0, 2 * 8 * (2 + 1))         # gene window + pool
    want += lin(1, 8, 8) + lin(1, 8, 8)                        # maps
    want += layer(1, 8, 16, 1, 1, 1, 1, 1)                     # one CRE layer
    want += 2 * layer(2, 8, 16, 4, 2, 2, 1, 1)                 # two gene layers (G1 = 2)
    want += lin(1, 8, 8) + t(0, 2 * 1 * 16) + lin(1, 8, 8) + lin(1, 8, 1)
    assert flops.least_time(cfg, [gene]) == pytest.approx(want, rel=1e-12)


def test_least_time_is_under_the_step_at_full_size():
    """At the bench's batch the least time stays below what PERF.md's
    forward took on the card (211.667 ms) and above the FLOP bound."""
    genes = [flops.GeneShape((200,) * 384, (200,) * 200, 54)] * 4
    lt = flops.least_time(CFG, genes)
    assert flops.batch_flops(CFG, genes)["total"] / 989e12 <= lt < 0.211667
