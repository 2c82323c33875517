"""Process groups for the port's mesh: the port of
``variantformer_tpu/parallel/launch.py`` on ``torch.distributed``.

One process per device. ``initialize_distributed`` brings the default
process group up (world size 1 included) and fixes the rank's device: the
backend follows it, NCCL for a card and gloo for the CPU, unless the caller
names one (two ranks on one card must take gloo: NCCL refuses two ranks on
one device). Every process then calls the same API on the same inputs;
``parallel/mesh.py`` splits the work and gathers the results.

    python -m torch.distributed.run --nproc-per-node 4 my_script.py   # torchrun
    # my_script.py:
    initialize_distributed()        # env:// from torchrun, cuda:{LOCAL_RANK}
    proc.use_mesh(make_mesh())
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_DEVICE: torch.device | None = None


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: ``device`` when given, else the one
    ``initialize_distributed`` fixed, else ``cuda:{LOCAL_RANK}``. A card
    index that does not exist raises; an index is never taken modulo the
    card count (that would put two ranks on one card unasked)."""
    if device is None:
        if _DEVICE is not None:
            return _DEVICE
        device = "cuda"
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dev.index >= count:
        raise RuntimeError(
            f"rank device {dev} does not exist: this host has {count} CUDA "
            "device(s); pass device= (e.g. 'cpu', or 'cuda:0' with backend='gloo' "
            "for several ranks on one card)")
    return dev


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device | None = None,
    backend: str | None = None,
    init_method: str | None = None,
    timeout_s: float = 600.0,
) -> dict:
    """Bring up the default process group; idempotent.

    The rendezvous is ``init_method`` when given (``file://`` suits tests),
    else ``tcp://{coordinator_address}``, else ``env://`` when ``MASTER_ADDR``
    is set (torchrun), else a world of one in this process. ``num_processes``
    and ``process_id`` default to ``WORLD_SIZE`` and ``RANK``. Returns the
    JAX package's four keys: ``process_index``, ``process_count``,
    ``local_devices`` (1: one device per process) and ``global_devices``."""
    global _DEVICE
    if not dist.is_initialized():
        dev = rank_device(device if device is not None else "cuda")
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        world = num_processes if num_processes is not None else int(
            os.environ.get("WORLD_SIZE", "1"))
        rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
        if init_method is None and coordinator_address is not None:
            init_method = f"tcp://{coordinator_address}"
        if init_method is None and "MASTER_ADDR" in os.environ:
            init_method = "env://"
        kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
        if backend == "nccl":
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        if init_method is None:
            if world != 1:
                raise ValueError(
                    f"a world of {world} processes needs coordinator_address, "
                    "init_method or the env:// variables (MASTER_ADDR, MASTER_PORT)")
            dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1, **kw)
        else:
            dist.init_process_group(init_method=init_method, rank=rank, world_size=world, **kw)
        _DEVICE = dev
    info = {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }
    log.info("distributed topology: %s (%s on %s)", info, dist.get_backend(), rank_device())
    return info


def shutdown_distributed() -> None:
    """Tear down what ``initialize_distributed`` brought up: the default
    process group and the rank's device, so a later call starts afresh."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def shard_query_across_hosts(items: list, process_index: int | None = None,
                             process_count: int | None = None) -> list:
    """Round-robin split of a work list (genes, variants) across processes:
    the data parallelism of genome-wide sweeps."""
    up = dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None else process_count
    return items[pi::pc]


def globalize_train_state(state, mesh):
    """Identical per-process TrainState -> the same values on every rank of
    ``mesh``: each parameter (and any optimizer moment) is broadcast in
    place from the mesh's first rank, so ranks that restored or initialised
    their own copies start in lockstep. The donor-partition step
    (``parallel/mesh.donor_dp_train_step``) then keeps them there."""
    from variantformer_tpu_torch.models.params import leaves
    from variantformer_tpu_torch.parallel import comm

    src = int(mesh.devices.reshape(-1)[0])
    with torch.no_grad():
        for t in leaves(state.params):
            comm.broadcast(t, src, mesh.all_group)
        inner = getattr(state.opt, "inner", state.opt)
        for moments in inner.state.values():
            for v in moments.values():
                if isinstance(v, torch.Tensor) and v.dim():
                    comm.broadcast(v, src, mesh.all_group)
    return state


def globalize_step_args(args: tuple, mesh) -> tuple:
    """Per-process step args -> this rank's shard of the global batch.

    Each process contributes its OWN donors, so its args already are its
    shard of the donor partition over every rank of ``mesh``
    (``donor_dp_train_step``); they move to the rank's device. The
    counterpart of ``parallel.mesh.shard_step_args`` for runs that read
    their data per process."""
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    dev = mesh.device
    out = []
    for a in args:
        if isinstance(a, Seq2GeneBatch):
            out.append(Seq2GeneBatch(*(None if v is None else torch.as_tensor(v).to(dev)
                                       for v in a)))
        elif getattr(a, "ndim", 0) >= 1:
            out.append(torch.as_tensor(a).to(dev))
        else:
            out.append(a)
    return tuple(out)
