"""The rank worker of the port's multi-process tests.

``launch(world, scenarios, out_dir)`` spawns ``world`` processes that bring
up a gloo process group over a ``file://`` store under ``out_dir`` (no TCP
port), run the same scenarios in the same order (every collective needs all
ranks) and each save their results. A spawned child imports only torch,
numpy, pandas and the port: the JAX references are computed in the parent.
The process group has a timeout and the spawn a wall-clock limit, so a hung
collective fails in seconds.

A scenario is ``(name, function name, kwargs)``; kwargs hold numpy trees,
port configs and paths, and each function returns numpy values.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def launch(world: int, scenarios: list, out_dir, timeout_s: float = 240.0) -> list[dict]:
    """Run ``scenarios`` on ``world`` ranks; returns each rank's results."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(scenarios, out_dir / "job.pt")
    ctx = mp.start_processes(_rank_main, args=(world, str(out_dir)), nprocs=world,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world}-rank world still running after {timeout_s} s")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, out_dir: str) -> None:
    from variantformer_tpu_torch.parallel.launch import initialize_distributed, shutdown_distributed

    torch.set_num_threads(1)
    scenarios = torch.load(Path(out_dir) / "job.pt", weights_only=False)
    initialize_distributed(num_processes=world, process_id=rank, device="cpu",
                           init_method=f"file://{out_dir}/store", timeout_s=60)
    results = {}
    try:
        for name, fn, kwargs in scenarios:
            results[name] = globals()[fn](**kwargs)
    finally:
        shutdown_distributed()
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")


def _np(out) -> dict:
    return {k: v.detach().float().numpy() for k, v in out._asdict().items() if v is not None}


def _batch(tree):
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    return Seq2GeneBatch(**{k: None if v is None else torch.from_numpy(np.array(v))
                            for k, v in tree.items()})


# -- inference -----------------------------------------------------------------


def topology() -> dict:
    from variantformer_tpu_torch.parallel import launch as plaunch
    from variantformer_tpu_torch.parallel.mesh import make_mesh

    info = plaunch.initialize_distributed(device="cpu")  # idempotent
    meshes = {m: make_mesh(num_model=m) for m in (1, 2) if dist.get_world_size() % m == 0}
    return {"info": info, "default": dict(make_mesh().shape),
            "meshes": {m: (dict(x.shape), x.coords) for m, x in meshes.items()},
            "hosts": plaunch.shard_query_across_hosts(list(range(10)))}


def forwards(cfg, params, batches: dict, num_model: int, ckpt: str | None = None) -> dict:
    """Every mesh forward of ``parallel/mesh.py`` on the tiny model, each
    output whole on every rank."""
    from variantformer_tpu_torch.models.checkpoint import load_checkpoint
    from variantformer_tpu_torch.models.params import leaves, to_tensors
    from variantformer_tpu_torch.parallel import mesh as pmesh

    out: dict = {}
    mesh = pmesh.make_mesh(num_model=num_model)
    whole = to_tensors(params, "cpu")
    sharded = pmesh.shard_params(whole, mesh)
    fwd = pmesh.sharded_forward(cfg, mesh)
    out["tp_donor"] = _np(fwd(sharded, pmesh.shard_batch(_batch(batches["donor"]), mesh)))
    # An odd donor count straight to shard_batch: replicated, not gathered twice.
    odd = pmesh.shard_batch(_batch(batches["odd"]), mesh)
    out["odd_split"] = odd.donors
    out["tp_odd"] = _np(fwd(sharded, odd))
    padded, t = pmesh.pad_tissue_axis(_batch(batches["tissue"]), mesh)
    out["tissue_padded"] = (padded.tissue_ids.shape[0], padded.cre_tokens.shape[1],
                            padded.gene_tokens.shape[1], t)
    res = fwd(sharded, pmesh.shard_batch(padded, mesh, partition="tissue"))
    out["tp_tissue"] = {k: v[:, :t] for k, v in _np(res).items()}
    # The kernel route's programs over every rank.
    repl = pmesh.replicate_params(whole, mesh)
    mb = pmesh.shard_batch_donor_all(_batch(batches["donor_all"]), mesh)
    out["dp_donor"] = _np(pmesh.donor_dp_forward(cfg, mesh, impl="fused2")(repl, mb))
    padded, t = pmesh.pad_tissue_axis(_batch(batches["tissue"]), mesh, multiple=mesh.size)
    mb = pmesh.shard_batch_tissue_all(padded, mesh)
    res = pmesh.tissue_dp_forward(cfg, mesh, impl="fused2")(repl, mb)
    out["dp_tissue"] = {k: v[:, :t] for k, v in _np(res).items()}
    if ckpt is not None:
        restored, _ = load_checkpoint(ckpt, device="cpu", mesh=mesh)
        out["ckpt_equal"] = all(torch.equal(a, b) for a, b in
                                zip(leaves(restored), leaves(sharded), strict=True))
        out["ckpt_shapes"] = [tuple(t.shape) for t in leaves(restored)]
    return out


def _csv_sources(paths: dict):
    import pandas as pd

    from variantformer_tpu_torch.api.vcfprocessor import DataSources

    maps = {g: pd.read_csv(p) for g, p in paths["cre_maps"].items()}
    return DataSources(fasta_path=paths["fasta"], gencode_path=paths["gencode"],
                       bpe_vocab_path=paths["bpe_vocab"], tissue_vocab_path=paths["tissue_vocab"],
                       cre_map_provider=lambda g: maps[g])


def processors(cfg, params, paths: dict, num_model: int, genes: list, tissues: list,
               out_dir: str, context: dict) -> dict:
    """The processors' flows on a mesh: a genome-wide sweep through
    ``use_mesh`` (the layered route, and the kernel route's donor program),
    ``predict`` under the tissue partition (also for ``context``'s config,
    whose encoder is layered), and the route and pack transitions of
    re-meshing."""
    import pandas as pd

    from variantformer_tpu_torch.api.sweeps import genome_wide_expression
    from variantformer_tpu_torch.api.variantprocessor import VariantProcessor
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.parallel.mesh import make_mesh

    sources = _csv_sources(paths)
    mesh = make_mesh(num_model=num_model)
    out: dict = {}

    def frame(df):
        df = df.drop_duplicates(["gene_id", "tissue"]).sort_values(["gene_id", "tissue"])
        return {"gene_id": list(df["gene_id"]), "tissue": list(df["tissue"]),
                "pred": df["predicted_expression"].to_numpy(np.float64)}

    for impl in ("xla", "fused2"):
        proc = VCFProcessor(sources=sources, config=cfg, device="cpu", impl=impl)
        proc.set_params(params)
        proc.use_mesh(mesh)
        out[f"sweep_{impl}"] = frame(genome_wide_expression(
            proc, paths["vcf"], tissues, genes=genes, batch_size=len(genes)))
        out[f"route_{impl}"] = (proc.impl, proc._mesh_fused, "gene_layers_packed" in proc._params)
    # The kernel route survives the tissue partition and re-meshing.
    query = pd.DataFrame({"gene_id": [genes[0]], "tissues": [",".join(tissues)]})
    proc.use_mesh(mesh, partition="tissue")
    out["tissue_fused2"] = np.stack(proc.predict(paths["vcf"], query, batch_size=1)
                                    ["predicted_expression"].to_numpy())
    out["tissue_route"] = (proc.impl, proc._mesh_fused, "gene_layers_packed" in proc._params)
    proc.use_mesh(mesh, partition="donor")
    out["remesh_route"] = (proc.impl, proc._mesh_fused, "gene_layers_packed" in proc._params)
    proc._reset_mesh()
    out["reset_route"] = (proc.impl, proc._mesh is None, "gene_layers_packed" in proc._params)
    xla = VCFProcessor(sources=sources, config=cfg, device="cpu", impl="xla")
    xla.set_params(params)
    xla.use_mesh(mesh, partition="tissue")
    out["tissue_xla"] = np.stack(xla.predict(paths["vcf"], query, batch_size=1)
                                 ["predicted_expression"].to_numpy())
    ctx = VCFProcessor(sources=sources, config=context["cfg"], device="cpu", impl="fused2")
    ctx.set_params(context["params"])
    ctx.use_mesh(mesh, partition="tissue")
    out["context_tissue"] = np.stack(ctx.predict(paths["vcf"], query, batch_size=1)
                                     ["predicted_expression"].to_numpy())
    out["context_route"] = (ctx.impl, ctx._mesh_fused, "gene_layers_packed" in ctx._params,
                            "layers_packed" in ctx._params["cre_tokenizer"])
    from variantformer_tpu_torch.data.pipeline import pack_samples

    batch = pack_samples([xla._builder(paths["vcf"]).build(genes[0])], [0, 1])
    try:
        xla._forward(batch, return_streams=True)
        out["streams_refused"] = False
    except ValueError:
        out["streams_refused"] = True
    # VEP through the mesh (ref-once cache off there). No remote fetch: the
    # REF_HG38 sequences then come from the local consensus.
    from variantformer_tpu_torch.utils import assets

    def refuse(self, rel, dst):
        raise AssertionError(f"remote fetch of {rel} attempted")

    assets.CachedFetcher._default_transport = refuse
    os.environ["VFX_FETCH_RETRY_TIMEOUT"] = "0"
    vep = VariantProcessor(sources=sources, config=cfg, device="cpu", impl="fused2")
    vep.set_params(params)
    vep.use_mesh(mesh)
    frame = vep.predict(pd.DataFrame(paths["variants"]),
                        str(Path(out_dir) / f"vep{dist.get_rank()}"),
                        vcf_path=paths["vcf"], sample_name="S1")
    out["vep"] = frame
    out["vep_stats"] = dict(vep.vep_stats)
    return out


# -- training ------------------------------------------------------------------


def _state(cfg, params, optimizer_kw: dict):
    from variantformer_tpu_torch.models.params import to_tensors
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import TrainState

    p = to_tensors(params, "cpu")
    opt = make_optimizer(p, **optimizer_kw)
    return TrainState(p, opt, 0)


def _numpy_tree(tree):
    from variantformer_tpu_torch.models.params import to_numpy

    return to_numpy(tree)


def globalize(cfg, params, batch, targets) -> dict:
    """``globalize_train_state``: a rank's own perturbed copy becomes the
    mesh's first rank's; ``globalize_step_args`` keeps this rank's args."""
    from variantformer_tpu_torch.models.params import leaves
    from variantformer_tpu_torch.parallel.launch import globalize_step_args, globalize_train_state
    from variantformer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(num_model=1)
    state = _state(cfg, params, {})
    with torch.no_grad():
        leaves(state.params)[0].add_(float(dist.get_rank()))
    globalize_train_state(state, mesh)
    args = globalize_step_args((_batch(batch), targets, 0.5), mesh)
    return {"first": leaves(state.params)[0].detach().numpy(),
            "args": [a if not hasattr(a, "numpy") else a.numpy() for a in args[1:]],
            "tokens": args[0].cre_tokens.numpy()}


def gspmd_steps(cfg, params, batch, targets, mask, num_model: int, steps: int = 2) -> dict:
    """``shard_train_state`` + the layered-route step on a (data, model)
    mesh: two steps' losses and the whole parameters after them."""
    from variantformer_tpu_torch.parallel import mesh as pmesh
    from variantformer_tpu_torch.train.steps import make_seq2gene_train_step

    mesh = pmesh.make_mesh(num_model=num_model)
    state = _state(cfg, params, dict(learning_rate=1e-3, weight_decay=0.01, optimizer="adamw"))
    step = make_seq2gene_train_step(cfg, state.opt, impl="xla")
    state = pmesh.shard_train_state(state, mesh)
    args = pmesh.shard_step_args((_batch(batch), torch.from_numpy(targets),
                                  torch.from_numpy(mask)), mesh)
    losses = []
    for _ in range(steps):
        state, loss = step(state, *args, 1.0)
        losses.append(float(loss))
    return {"losses": losses,
            "params": _numpy_tree(pmesh.unshard_params(state.params, mesh))}


def donor_dp(cfg, params, batch, targets, mask, impl: str = "fused2", steps: int = 2) -> dict:
    """``donor_dp_train_step`` over every rank, twice from the same state
    (the gradients' bits must repeat), and with a ZeRO-1 optimizer."""
    from variantformer_tpu_torch.models.params import leaves
    from variantformer_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(num_model=1)
    shard = pmesh.donor_dp_shard_fn(mesh)
    args = shard((_batch(batch), torch.from_numpy(targets), torch.from_numpy(mask)))
    out: dict = {}
    kw = dict(learning_rate=1e-3, weight_decay=0.01, optimizer="adamw",
              train_gene_tokenizer=True)
    grads = []
    for _ in range(2):
        state = pmesh.replicate_train_state(_state(cfg, params, kw), mesh)
        vg = pmesh.donor_dp_value_and_grad(cfg, mesh, impl=impl)
        loss = vg(state.params, *args)
        grads.append([None if t.grad is None else t.grad.clone() for t in leaves(state.params)])
    out["vg_loss"] = float(loss)
    out["grads"] = [None if g is None else g.numpy() for g in grads[0]]
    out["grads_repeat"] = all((a is None and b is None) or torch.equal(a, b)
                              for a, b in zip(*grads, strict=True))
    for zero1 in (False, True):
        state = pmesh.replicate_train_state(_state(cfg, params, kw), mesh)
        if zero1:
            state = state._replace(opt=pmesh.Zero1Optimizer(state.opt, mesh))
        step = pmesh.donor_dp_train_step(cfg, mesh, state.opt, impl=impl,
                                         shard_optimizer=zero1)
        losses = []
        for _ in range(steps):
            state, loss = step(state, *args, 1.0)
            losses.append(float(loss))
        key = "zero1" if zero1 else "dp"
        out[f"{key}_losses"] = losses
        out[f"{key}_params"] = _numpy_tree(state.params)
        if zero1:
            from variantformer_tpu_torch.train.optimizer import base_optimizer

            moments = base_optimizer(state.opt.opt).state_dict()["state"]
            out["zero1_moment_shapes"] = [tuple(moments[i]["exp_avg"].shape)
                                          for i in sorted(moments)]
            out["zero1_specs"] = pmesh.opt_state_specs(state.opt, mesh)
            full = state.opt.state_dict()["state"]
            out["zero1_full_shapes"] = [tuple(full[i]["exp_avg"].shape) for i in sorted(full)]
            out["zero1_unsliced"] = sum(a is None for a in out["zero1_specs"])
    # ZeRO-1 against the replicated optimizer through checkpoints: the whole
    # state_dict taken after every step (as fit saves each epoch) and, with
    # accumulate_steps=2, loaded back in the middle of each cycle. The
    # targets change from micro-step to micro-step, so a lost accumulator
    # shows in the update.
    for acc in (1, 2):
        runs = {}
        for zero1 in (False, True):
            state = pmesh.replicate_train_state(
                _state(cfg, params, {**kw, "accumulate_steps": acc}), mesh)
            if zero1:
                state = state._replace(opt=pmesh.Zero1Optimizer(state.opt, mesh))
            step = pmesh.donor_dp_train_step(cfg, mesh, state.opt, impl=impl,
                                             shard_optimizer=zero1)
            losses = []
            for i in range(3 * acc):
                state, loss = step(state, args[0], args[1] * (1 + 0.25 * i), args[2], 1.0)
                losses.append(float(loss))
                saved = state.opt.state_dict()
                if (i + 1) % acc:
                    state.opt.load_state_dict(saved)
            runs["zero1" if zero1 else "dp"] = {"losses": losses,
                                                "params": _numpy_tree(state.params)}
        out[f"ckpt_acc{acc}"] = runs
    return out


def fit_runs(cfg, params, shard_dir: str, tissues: list, ckpt_dir: str, num_model: int,
             kind: str, batch_size: int) -> dict:
    """``fit`` on a mesh: ``mesh=`` (the layered route split over a model
    axis) or ``shard_fn=donor_dp_shard_fn`` with ``donor_dp_train_step``;
    checkpoints written by rank 0, then a resume on every rank."""
    from variantformer_tpu_torch.parallel import mesh as pmesh
    from variantformer_tpu_torch.train.loop import (
        fit,
        make_seq2gene_eval_loss,
        seq2gene_shard_batches,
    )
    from variantformer_tpu_torch.train.steps import make_seq2gene_train_step

    batches = seq2gene_shard_batches(shard_dir, tissues, batch_size=batch_size, shuffle=False,
                                     device="cpu")
    if kind == "gspmd":
        mesh = pmesh.make_mesh(num_model=num_model)
        state = _state(cfg, params, dict(learning_rate=1e-3))
        step = make_seq2gene_train_step(cfg, state.opt, impl="xla")
        ev = make_seq2gene_eval_loss(cfg, batches, shard_fn=pmesh.data_shard_fn(mesh),
                                     impl="xla")
        res = fit(state, step, batches, epochs=2, mesh=mesh, eval_loss=ev, ckpt_dir=ckpt_dir)
        state2 = _state(cfg, params, dict(learning_rate=1e-3))
        again = fit(state2, make_seq2gene_train_step(cfg, state2.opt, impl="xla"), batches,
                    epochs=3, mesh=mesh, eval_loss=ev, ckpt_dir=ckpt_dir, resume=True)
    else:
        mesh = pmesh.make_mesh(num_model=1)
        state = pmesh.replicate_train_state(_state(cfg, params, dict(learning_rate=1e-3)), mesh)
        step = pmesh.donor_dp_train_step(cfg, mesh, state.opt, impl="fused")
        shard = pmesh.donor_dp_shard_fn(mesh)
        ev = make_seq2gene_eval_loss(cfg, batches, shard_fn=shard, impl="fused")
        res = fit(state, step, batches, epochs=2, shard_fn=shard, eval_loss=ev,
                  ckpt_dir=ckpt_dir)
        again = None
    return {"history": res.history, "resumed": None if again is None else again.history}


def seq2reg_fit(wcfg_fields: dict, params, shard_dir: str, num_model: int) -> dict:
    """Window-classifier training through ``fit(mesh=...)``, with the eval
    loss and metrics on the same placement."""
    from variantformer_tpu_torch.config import ModelConfig, WindowEncoderConfig
    from variantformer_tpu_torch.parallel import mesh as pmesh
    from variantformer_tpu_torch.train.loop import (
        fit,
        make_seq2reg_eval_loss,
        seq2reg_shard_batches,
    )
    from variantformer_tpu_torch.train.metrics import make_seq2reg_eval_metrics
    from variantformer_tpu_torch.train.steps import make_seq2reg_train_step

    cfg = ModelConfig(window_encoder=WindowEncoderConfig(**wcfg_fields))
    mesh = pmesh.make_mesh(num_model=num_model)
    batches = seq2reg_shard_batches(shard_dir, {"liver": 1}, shuffle=False, device="cpu")
    state = _state(cfg, params, dict(learning_rate=1e-3))
    step = make_seq2reg_train_step(cfg, state.opt)
    shard = pmesh.data_shard_fn(mesh)
    res = fit(state, step, batches, epochs=2, mesh=mesh,
              eval_loss=make_seq2reg_eval_loss(cfg, batches, shard_fn=shard))
    metrics = make_seq2reg_eval_metrics(cfg, batches, ["a", "b"], shard_fn=shard)(res.state)
    return {"history": res.history, "metrics": metrics}
