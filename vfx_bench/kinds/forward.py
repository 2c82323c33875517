"""Traffic kind ``forward``: the model step alone, closed loop, one stream.

Batches of ``donors`` genes, each ``cre_windows`` CRE windows and
``gene_windows`` gene windows of ``tokens`` tokens, every window full, random
token ids, random cCRE classes and ``tissues`` random tissue ids (a copy of
the port's bench generator, ``bench.example_batch``, seeded from the run's
seed); ``batches`` of them are cycled. Each call is ``seq2gene_forward``
on the weights packed as the processor packs them, and its prediction and
pooled embedding are copied to the host. The rate is genes of the calls
completed over the window's time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vfx_bench import compare, flops
from vfx_bench.harness import program_config
from vfx_bench.weights import make_weights


def example_batch(tr: dict, vocab: int, seed: int, k: int) -> dict:
    """Batch ``k`` of a run (numpy int32 leaves)."""
    d, c, g, length, t = (tr["donors"], tr["cre_windows"], tr["gene_windows"], tr["tokens"],
                          tr["tissues"])
    rng = np.random.default_rng([seed, 10, k])
    arrays = dict(
        cre_tokens=rng.integers(4, vocab, (d, c, length)),
        cre_tok_len=np.full((d, c), length),
        cre_count=np.full((d,), c),
        cre_labels=rng.integers(0, 9, (d, c)),
        gene_tokens=rng.integers(4, vocab, (d, g, length)),
        gene_tok_len=np.full((d, g), length),
        gene_count=np.full((d,), g),
        tissue_ids=rng.integers(0, 63, (t,)),
    )
    return {k: a.astype(np.int32) for k, a in arrays.items()}


def shapes(batch: dict) -> list[flops.GeneShape]:
    t = len(batch["tissue_ids"])
    return [flops.GeneShape(tuple(batch["cre_tok_len"][i, :batch["cre_count"][i]].tolist()),
                            tuple(batch["gene_tok_len"][i, :batch["gene_count"][i]].tolist()), t)
            for i in range(len(batch["cre_count"]))]


def setup(run) -> dict:
    from variantformer_tpu_torch.bench import packed_params
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    cfg, tr = run.cfg, run.cell.traffic
    dev = torch.device(run.device)
    pcfg = program_config(cfg)
    host = [example_batch(tr, cfg["window_encoder"]["vocab_size"], run.seed, k)
            for k in range(tr["batches"])]
    params = packed_params(pcfg, make_weights(cfg, run.seed, dev,
                                              compare.DTYPES[cfg["serve"]["weights_dtype"]]))
    batches = [Seq2GeneBatch(**{k: torch.as_tensor(v, device=dev) for k, v in b.items()})
               for b in host]
    state = {"params": params, "batches": batches, "host": host, "pcfg": pcfg}
    _call(state, 0, cfg)  # builds the kernels; every batch has this one shape
    return state


def _call(state: dict, k: int, cfg: dict):
    from variantformer_tpu_torch.models.seq2gene import seq2gene_forward

    with torch.inference_mode(), torch.profiler.record_function("vfx_bench.forward"):
        out = seq2gene_forward(state["params"], state["batches"][k], state["pcfg"],
                               impl=cfg["serve"]["impl"])
        return out.pred_expression.cpu().numpy(), out.pooled_embedding.cpu().numpy()


def window(run, state: dict) -> None:
    n_b = len(state["batches"])
    kept = {}
    n = 0
    t0 = time.perf_counter()
    while True:
        kept[n % n_b] = _call(state, n % n_b, run.cfg)
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= run.seconds:
            break
    genes = [s for k in range(n) for s in shapes(state["host"][k % n_b])]
    run.attempted = n
    run.kept["outputs"] = kept
    run.counters.update(window_s=elapsed, calls=n, genes=len(genes),
                        flops=flops.batch_flops(run.cfg, genes)["total"])
    run.end_to_end["genes_per_s"] = len(genes) / elapsed


def traced(run, state: dict, tracer) -> None:
    n_b = len(state["batches"])
    calls = run.cell.traffic["trace_calls"]
    with tracer.window():
        for k in range(calls):
            _call(state, k % n_b, run.cfg)
    batches = [shapes(state["host"][k % n_b]) for k in range(calls)]
    run.counters.update(trace_calls=calls, trace_genes=sum(map(len, batches)),
                        **flops.least_counters(run.cfg, batches))


def release(run, state: dict) -> None:
    run.kept["host"] = state["host"]
    state.clear()


def check(run) -> None:
    run.readings.update(_gaps(run, {k: v for k, v in sorted(run.kept["outputs"].items())},
                              run.kept["host"]))


def _gaps(run, outputs: dict, host: list) -> dict:
    """The reference over every gene of the batches the window produced;
    each number the largest over the batches (the genes of a batch share
    their tissues, and the gaps are measured against how far they differ)."""
    cfg, dev = run.cfg, torch.device(run.device)
    params = compare.reference_params(cfg, run.seed, dev, cfg["serve"]["weights_dtype"])
    out: dict = {}
    for k, (pred, emb) in outputs.items():
        b = host[k]
        ref = compare.reference_outputs(
            cfg, params, [compare.valid_windows(b, i) for i in range(pred.shape[0])],
            b["tissue_ids"], dev)
        gaps = compare.serve_gaps([(pred[i], emb[i]) for i in range(pred.shape[0])], ref)
        out = {n: max(v, out.get(n, v)) for n, v in gaps.items()}
    return out


def control(run) -> dict:
    """The numbers compared with the reference in float8 in the program's
    place, on the batches of the run's seed."""
    cfg, tr, dev = run.cfg, run.cell.traffic, torch.device(run.device)
    host = [example_batch(tr, cfg["window_encoder"]["vocab_size"], run.seed, k)
            for k in range(tr["batches"])]
    params = compare.reference_params(cfg, run.seed, dev, cfg["serve"]["weights_dtype"])
    outputs = {}
    for k, b in enumerate(host):
        outs = compare.reference_outputs(
            cfg, params, [compare.valid_windows(b, i) for i in range(len(b["cre_count"]))],
            b["tissue_ids"], dev, fp8=True)
        outputs[k] = (np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs]))
    del params
    return _gaps(run, outputs, host)
