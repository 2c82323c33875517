"""The plain reference held against the port's plain versions at tiny sizes
on the CPU: the forward and a training step at float32, and the host
pipeline's tokens on both of the port's engines."""

import types

import numpy as np
import pytest
import torch

from vfx_bench import compare, harness
from vfx_bench.genome import Genome
from vfx_bench.kinds import finetune
from vfx_bench.reference import host
from vfx_bench.reference.model import Matmul
from vfx_bench.tests.tiny import GENOME, tiny_config
from vfx_bench.weights import make_weights, tree_leaves


def f32_config():
    cfg = tiny_config("v4_pcg_ft")
    cfg["precision"] = {"param_dtype": "float32", "compute_dtype": "float32",
                        "softmax_dtype": "float32"}
    return cfg


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    return Genome(tmp_path_factory.mktemp("genome"), GENOME, 2**31 + 3, 3)


def port_builder(g, cfg, native):
    import pandas as pd
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder
    from variantformer_tpu_torch.utils.bpe import BPETokenizer
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import ConsensusEngine, VCFReader

    b = GeneSampleBuilder(harness.program_config(cfg).dataset, FastaReader(str(g.root / "genome.fa")),
                          BPETokenizer.from_file(str(host.VOCAB), use_native=native),
                          pd.read_csv(g.root / "gencode.csv"), g.cre_maps.get,
                          vcf=VCFReader(g.vcfs[1]))
    if not native:
        b.engine = ConsensusEngine(b.engine.fasta, b.engine.vcf, use_native=False)
    return b


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_host_tokens_equal_the_ports(genome, native):
    from vfx_bench import serving

    cfg = tiny_config()
    b = port_builder(genome, cfg, native)
    mine = host.build_many(serving.jobs(genome, cfg["dataset"],
                                        [(gid, genome.vcfs[1]) for gid in genome.genes]), 1)
    for gid, ref in zip(genome.genes, mine):
        s = b.build(gid)
        for k in ref:
            np.testing.assert_array_equal(getattr(s, k), ref[k], err_msg=f"{gid} {k}")


def test_vcf_index_serves_the_ports_queries(genome):
    from variantformer_tpu_torch.utils.vcf import VCFReader

    indexed, scan = VCFReader(genome.vcfs[0]), VCFReader(genome.vcfs[0], use_index=False)
    assert indexed._index is not None
    n = len(genome.seq)
    for a in range(0, n, 337):
        assert indexed.query("chr1", a, a + 900) == scan.query("chr1", a, a + 900)


def _batch(genome, cfg, genes, tissues):
    from variantformer_tpu_torch.data.pipeline import pack_samples
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    b = port_builder(genome, cfg, True)
    packed = pack_samples([b.build(g) for g in genes], tissue_ids=tissues)
    return packed, Seq2GeneBatch(*(None if v is None else torch.as_tensor(v) for v in packed))


def test_forward_equals_the_ports_plain_forward_at_f32(genome):
    from variantformer_tpu_torch.models.seq2gene import seq2gene_forward_plain

    cfg = f32_config()
    params = make_weights(cfg, 11, "cpu", torch.float32)
    packed, batch = _batch(genome, cfg, genome.genes[:3], [0, 2, 1])
    port = seq2gene_forward_plain(params, batch, harness.program_config(cfg))
    samples = [compare.valid_windows(packed._asdict(), i) for i in range(3)]
    ref = compare.reference_outputs(cfg, params, samples, [0, 2, 1], "cpu")
    prog = [(port.pred_expression[i].numpy(), port.pooled_embedding[i].numpy())
            for i in range(3)]
    gaps = compare.serve_gaps(prog, ref)
    assert gaps["pred_gap"] < 1e-3 and gaps["emb_gap"] < 1e-3, gaps  # bf16 reads ~0.3


def test_train_step_equals_the_ports_at_f32(genome):
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import TrainState, make_seq2gene_train_step

    cfg = f32_config()
    cfg["train"]["impl"] = "xla"
    pcfg = harness.program_config(cfg)
    genes = genome.genes[:2]
    packed, batch = _batch(genome, cfg, genes, [0, 1, 2])
    run = types.SimpleNamespace(cfg=cfg, seed=5, device="cpu",
                                kept={"g": genome}, cell=None)
    targets = finetune._labels(run, genes)
    params = make_weights(cfg, 5, "cpu", torch.float32)
    p0 = {n: p.clone() for n, p in tree_leaves(params)}
    opt = make_optimizer(params, learning_rate=1e-2, train_gene_tokenizer=True)
    step = make_seq2gene_train_step(pcfg, opt, freeze_tokenizers=True,
                                    train_gene_tokenizer=True, impl="xla")
    state, loss = step(TrainState(params, opt, 0), batch, torch.as_tensor(targets),
                       torch.ones(targets.shape, dtype=torch.bool), 1.0)
    prog = {"losses": [float(loss)],
            "grad": finetune._leaf_norms(params, lambda n, p: opt.state[p]["exp_avg"] / 0.1
                                         if p in opt.state else None),
            "change": finetune._changes(params, p0)}
    cfg["train"]["learning_rate"] = 1e-2
    samples = [compare.valid_windows(packed._asdict(), i) for i in range(2)]
    ref = finetune.reference_training(run, [samples], [targets])
    r = finetune.readings(prog, ref)
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4 and r["update_gap"] < 1e-3, r


def test_weights_follow_the_seed():
    cfg = tiny_config()
    a, b, c = (tree_leaves(make_weights(cfg, s, "cpu", torch.bfloat16)) for s in (7, 7, 8))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert not all(torch.equal(x, y) for (_, x), (_, y) in zip(a, c))
    names = [n for n, _ in a]
    assert "gene_layers.cross.wkv.w" in names and "tissue_heads.b3" in names


def test_fp8_matmul_rounds_coarser_than_bf16():
    torch.manual_seed(0)
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    exact = a @ b
    bf16 = (a.bfloat16().float() @ b.bfloat16().float() - exact).norm() / exact.norm()
    fp8 = (Matmul(fp8=True)(a, b) - exact).norm() / exact.norm()
    assert fp8 > 4 * bf16
