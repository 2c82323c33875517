"""Traffic kind ``finetune``: seq2gene fine-tuning through the port's ``fit``.

Set-up writes one training shard per gene of the synthetic genome (one
donor, ``tissues`` log1p-TPM labels from the seed) with the port's
``TrainingShardWriter``, makes the f32 weights from the seed, the port's
Adam (``make_optimizer``) and train step (``make_seq2gene_train_step``,
the CRE tokenizer frozen, the gene tokenizer trained), and feeds
``seq2gene_shard_batches`` (``genes_per_step`` genes a step, shuffled)
into ``fit`` without a checkpoint directory. The first ``check_steps``
steps run in set-up through that same ``fit``, step and feed, on the one
training state the window then continues; what the comparison reads of
them is taken as they pass: each step's loss, each leaf's first gradient
(Adam's first moment after step 1 over 1 - beta1) and each leaf's change
after the last of them. The rate is genes trained over the window's time.
"""

from __future__ import annotations

import itertools
import math
import time

import numpy as np
import torch

from vfx_bench import flops, serving
from vfx_bench.harness import program_config
from vfx_bench.reference import host
from vfx_bench.reference.model import Seq2GeneReference, poisson_nll, strict_fp32
from vfx_bench.weights import leaf_specs, make_weights, tree_leaves

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
# A leaf of at most this many values keeps its whole change (not only its
# norm), so that the comparison can leave out, value by value, what the
# reference's gradient does not move (a key's bias under softmax).
SMALL_LEAF = 1 << 20


def _host(batch, targets) -> dict:
    out = {k: v.detach().cpu().numpy() for k, v in batch._asdict().items()
           if v is not None}
    out["tissues"] = targets.shape[1]
    return out


def setup(run) -> dict:
    import pandas as pd
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder
    from variantformer_tpu_torch.data.train_pipeline import TrainingShardWriter
    from variantformer_tpu_torch.train.loop import fit, seq2gene_shard_batches
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import TrainState, make_seq2gene_train_step
    from variantformer_tpu_torch.utils.bpe import BPETokenizer
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import VCFReader

    cfg, tr, dev = run.cfg, run.cell.traffic, torch.device(run.device)
    tcfg = cfg["train"]
    pcfg = program_config(cfg)
    g = serving.genome(run, donors=1)
    builder = GeneSampleBuilder(pcfg.dataset, FastaReader(str(g.root / "genome.fa")),
                                BPETokenizer.from_file(str(host.VOCAB)),
                                pd.read_csv(g.root / "gencode.csv"), g.cre_maps.get,
                                vcf=VCFReader(g.vcfs[0]))
    vocab = {t: i for i, t in enumerate(g.tissue_names)}
    shards = run.scratch / "shards"
    TrainingShardWriter({"donor0": builder}, g.expression(run.seed, ["donor0"]), vocab, shards,
                        label=tcfg["label"]).build_all(g.genes, ["donor0"],
                                                       max_workers=tr.get("build_workers", 8))
    params = make_weights(cfg, run.seed, dev, torch.float32)
    opt = make_optimizer(params, learning_rate=tcfg["learning_rate"],
                         weight_decay=tcfg["weight_decay"], optimizer=tcfg["optimizer"],
                         train_gene_tokenizer=tcfg["train_gene_tokenizer"])
    step = make_seq2gene_train_step(pcfg, opt, freeze_tokenizers=tcfg["freeze_cre_tokenizer"],
                                    train_gene_tokenizer=tcfg["train_gene_tokenizer"],
                                    impl=tcfg["impl"])
    feed = seq2gene_shard_batches(shards, list(range(len(g.tissue_names))),
                                  batch_size=tr["genes_per_step"], shuffle=True, device=dev)
    state = {"g": g, "shards": shards, "step": step, "feed": feed, "fit": fit,
             "train": TrainState(params, opt, 0), "epoch0": feed(0)}
    n = tr["check_steps"]
    seen = {"losses": [], "batches": []}

    def recording(st, batch, targets, mask, plateau_value=None):
        seen["batches"].append(_host(batch, targets))
        st, loss = step(st, batch, targets, mask, plateau_value)
        seen["losses"].append(float(loss))
        if st.step == 1:
            seen["grad"] = _leaf_norms(st.params, lambda name, p: (
                opt.state[p]["exp_avg"] / (1 - BETA1) if p in opt.state else None))
        if st.step == n:
            p0 = dict(tree_leaves(make_weights(cfg, run.seed, dev, torch.float32)))
            seen["change"] = _changes(st.params, p0)
            del p0
        return st, loss

    state["train"] = fit(state["train"], recording,
                         lambda epoch: itertools.islice(state["epoch0"], n)).state
    run.kept["seen"] = seen
    return state


def _leaf_norms(params: dict, fn) -> dict:
    out = {}
    with torch.no_grad():
        for name, p in tree_leaves(params):
            t = fn(name, p)
            out[name] = 0.0 if t is None else float(torch.linalg.vector_norm(t.double()))
    return out


def _changes(params: dict, p0: dict) -> dict:
    """Each leaf's change from ``p0``: the values of a small leaf (host f32),
    the norm of a large one."""
    out = {}
    with torch.no_grad():
        for name, p in tree_leaves(params):
            d = p.detach() - p0[name]
            out[name] = (d.float().cpu().numpy() if d.numel() <= SMALL_LEAF
                         else float(torch.linalg.vector_norm(d.double())))
    return out


def _steps(state: dict, t0: float, seconds: float, counter: list):
    """The window's batches: the rest of epoch 0, then epochs 1, 2, ...,
    until the window's time has passed. ``counter`` gets each batch's
    count leaves (device tensors, read after the window: no sync here)."""
    rest = itertools.chain([state["epoch0"]],
                           (state["feed"](e) for e in itertools.count(1)))
    for batch in itertools.chain.from_iterable(rest):
        if time.perf_counter() - t0 >= seconds:
            return
        b = batch[0]
        counter.append((b.cre_tok_len, b.cre_count, b.gene_tok_len, b.gene_count,
                        batch[1].shape[1]))
        yield batch


def _counted(counter: list) -> list[dict]:
    return [{"cre_tok_len": a.cpu().numpy(), "cre_count": b.cpu().numpy(),
             "gene_tok_len": c.cpu().numpy(), "gene_count": d.cpu().numpy(),
             "tissues": t} for a, b, c, d, t in counter]


def window(run, state: dict) -> None:
    count: list = []
    t0 = time.perf_counter()
    state["train"] = state["fit"](state["train"], state["step"],
                                  lambda epoch: _steps(state, t0, run.seconds, count)).state
    elapsed = time.perf_counter() - t0
    steps = _counted(count)
    genes = sum(len(b["cre_count"]) for b in steps)
    run.attempted = len(steps)
    run.counters.update(window_s=elapsed, steps=len(steps), genes=genes,
                        flops=sum(flops.train_flops(run.cfg, _shapes(b)) for b in steps))
    run.end_to_end["train_samples_per_s"] = genes / elapsed


def _shapes(b: dict) -> list[flops.GeneShape]:
    return [flops.GeneShape(tuple(b["cre_tok_len"][i, :b["cre_count"][i]].tolist()),
                            tuple(b["gene_tok_len"][i, :b["gene_count"][i]].tolist()),
                            b["tissues"])
            for i in range(len(b["cre_count"]))]


def _trained(run) -> int:
    """Values Adam updates: every leaf but the frozen CRE tokenizer's."""
    return sum(math.prod(shape) for path, shape, _, _ in leaf_specs(run.cfg)
               if path[0] != "cre_tokenizer")


def traced(run, state: dict, tracer) -> None:
    n = run.cell.traffic["trace_steps"]
    count: list = []
    with tracer.window(), torch.profiler.record_function("vfx_bench.fit"):
        state["train"] = state["fit"](state["train"], state["step"], lambda epoch: itertools.islice(
            _steps(state, time.perf_counter(), float("inf"), count), n)).state
    trained = _trained(run)
    run.counters.update(trace_calls=n, trace_least_s=sum(
        flops.least_time(run.cfg, _shapes(b), train=True, trained_params=trained)
        for b in _counted(count)))


def release(run, state: dict) -> None:
    run.kept["g"] = state["g"]
    run.kept["shards"] = state["shards"]
    state.clear()


# -- the comparison -------------------------------------------------------------
def _identify(shards, rows: dict) -> list[str]:
    """The gene of each batch row: the shard whose gene windows agree with
    the row's in the most tokens (the reference rebuilds that gene's
    windows itself and compares them with the row's)."""
    files = sorted(shards.glob("*__*.npz"))
    loaded = [(f.name.split("__")[0], np.load(f)["gene_tokens"]) for f in files]
    out = []
    for i in range(len(rows["gene_count"])):
        mine = rows["gene_tokens"][i, :rows["gene_count"][i]]
        score = [(np.sum(t == mine) if t.shape == mine.shape else -1, gid) for gid, t in loaded]
        out.append(max(score)[1])
    return out


def _mismatch(b: dict, i: int, ref: dict) -> int:
    c, g = int(b["cre_count"][i]), int(b["gene_count"][i])
    same = (c == len(ref["cre_tok_len"]) and g == len(ref["gene_tok_len"])
            and np.array_equal(b["cre_tokens"][i, :c], ref["cre_tokens"])
            and np.array_equal(b["cre_tok_len"][i, :c], ref["cre_tok_len"])
            and np.array_equal(b["cre_labels"][i, :c], ref["cre_labels"])
            and np.array_equal(b["gene_tokens"][i, :g], ref["gene_tokens"])
            and np.array_equal(b["gene_tok_len"][i, :g], ref["gene_tok_len"]))
    return int(not same)


def reference_training(run, steps: list[list[dict]], targets: list[np.ndarray],
                       fp8: bool = False) -> dict:
    """Plain f32 Adam training from the seed's weights over ``steps`` (each
    a list of genes' valid windows, ``targets`` [genes, T]); every tissue of
    every gene is labelled. Returns the losses, the first gradient's and
    the last change's norm of each leaf."""
    strict_fp32()
    cfg, dev = run.cfg, torch.device(run.device)
    tcfg = cfg["train"]
    params = make_weights(cfg, run.seed, dev, torch.float32)
    leaves = tree_leaves(params)
    p0 = {name: p.detach().clone() for name, p in leaves}
    trained = [(n, p) for n, p in leaves if not (tcfg["freeze_cre_tokenizer"]
                                                 and n.startswith("cre_tokenizer."))]
    for _, p in trained:
        p.requires_grad_(True)
    m = {n: torch.zeros_like(p) for n, p in trained}
    v = {n: torch.zeros_like(p) for n, p in trained}
    ref = Seq2GeneReference(cfg, params, fp8=fp8, remat=True)
    tis = torch.arange(targets[0].shape[1], device=dev)
    out = {"losses": []}
    for s, (genes, tgt) in enumerate(zip(steps, targets), start=1):
        count = float(tgt.size)
        total = 0.0
        for gene, y in zip(genes, tgt):
            t = {k: torch.as_tensor(np.asarray(a), device=dev) for k, a in gene.items()}
            pred, _ = ref.forward_gene(t["cre_tokens"], t["cre_tok_len"], t["cre_labels"],
                                       t["gene_tokens"], t["gene_tok_len"], tis)
            loss = poisson_nll(pred, torch.as_tensor(y, device=dev)).sum() / count
            loss.backward()
            total += loss.item()
        out["losses"].append(total)
        with torch.no_grad():
            if s == 1:
                out["grad"] = {n: 0.0 if p.grad is None else
                               float(torch.linalg.vector_norm(p.grad.double()))
                               for n, p in leaves}
                out["size"] = {n: p.numel() for n, p in leaves}
                out["grad_values"] = {n: p.grad.float().cpu().numpy() for n, p in leaves
                                      if p.grad is not None and p.numel() <= SMALL_LEAF}
            lr = tcfg["learning_rate"]
            for n, p in trained:
                if p.grad is None:
                    continue
                m[n].mul_(BETA1).add_(p.grad, alpha=1 - BETA1)
                v[n].mul_(BETA2).addcmul_(p.grad, p.grad, value=1 - BETA2)
                denom = (v[n] / (1 - BETA2 ** s)).sqrt_().add_(EPS)
                p.addcdiv_(m[n], denom, value=-lr / (1 - BETA1 ** s))
                p.grad = None
    out["change"] = _changes(params, p0)
    return out


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    names = [n for n in ref if keep is None or keep(n)]
    med = float(np.median([ref[n] for n in names if ref[n] > 0] or [0.0]))
    return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def readings(prog: dict, ref: dict) -> dict:
    """``loss_gap``, ``grad_gap``, ``update_gap``. The change leaves out a
    leaf whose reference gradient norm is under a thousandth of the median
    leaf's, and, inside a small leaf, each value whose reference gradient
    is under a thousandth of the median leaf's root mean square: such values
    move under Adam by round-off alone (a key's bias under softmax)."""
    g = ref["grad"]
    moved = [n for n in g if g[n] > 0]
    med = float(np.median([g[n] for n in moved]))
    tiny = 1e-3 * float(np.median([g[n] / math.sqrt(ref["size"][n]) for n in moved]))

    def norm(change, n):
        c = change[n]
        if not isinstance(c, np.ndarray):
            return c
        vals = ref["grad_values"].get(n)
        if vals is not None:
            c = c[np.abs(vals) >= tiny]
        return float(np.linalg.norm(c.astype(np.float64)))

    kept = [n for n in moved if g[n] >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": leaf_gap(prog["grad"], g, keep=lambda n: g[n] > 0),
        "update_gap": leaf_gap({n: norm(prog["change"], n) for n in kept},
                               {n: norm(ref["change"], n) for n in kept}),
    }


def _labels(run, genes: list[str]) -> np.ndarray:
    g = run.kept["g"]
    exp = g.expression(run.seed, ["donor0"]).set_index(["gene_id", "tissue"])["TPM"]
    label = run.cfg["train"]["label"]
    if label != "log1p_tpm":
        raise ValueError(f"the reference labels log1p_tpm only, not {label!r}")
    return np.stack([np.log1p(np.asarray([exp[(gid, t)] for t in g.tissue_names]))
                     .astype(np.float32) for gid in genes])


def _rebuild(run, genes: list[list[str]]) -> list[list[dict]]:
    """The reference's build of each step's genes, all in one pool."""
    g = run.kept["g"]
    flat = serving.rebuild(run, g, [(gid, g.vcfs[0]) for gs in genes for gid in gs])
    out, i = [], 0
    for gs in genes:
        out.append(flat[i:i + len(gs)])
        i += len(gs)
    return out


def check(run) -> None:
    seen = run.kept["seen"]
    genes = [_identify(run.kept["shards"], b) for b in seen["batches"]]
    steps = _rebuild(run, genes)
    mismatch = sum(_mismatch(b, i, r) for b, built in zip(seen["batches"], steps)
                   for i, r in enumerate(built))
    ref = reference_training(run, steps, [_labels(run, gs) for gs in genes])
    run.readings.update(readings(seen, ref), token_mismatch=float(mismatch))


def control(run) -> dict:
    """The numbers compared with the reference trained in float8 in the
    program's place, on the genes of the first steps (in shard order)."""
    g = run.kept["g"] = serving.genome(run, donors=1)
    k, n = run.cell.traffic["genes_per_step"], run.cell.traffic["check_steps"]
    order = np.random.default_rng([run.seed, 40]).permutation(len(g.genes))[:k * n]
    genes = [[g.genes[i] for i in order[s * k:(s + 1) * k]] for s in range(n)]
    steps = _rebuild(run, genes)
    targets = [_labels(run, gs) for gs in genes]
    low = reference_training(run, steps, targets, fp8=True)
    return readings(low, reference_training(run, steps, targets))
