"""The port's launch helpers (``variantformer_tpu_torch/parallel/launch.py``)
and the refusals around them, on the CPU.

``initialize_distributed`` brings a world of one up in this process (torn
down after each test), is idempotent and returns the JAX package's four
keys; ``shard_query_across_hosts`` gives the JAX package's split;
``use_mesh``/``make_mesh`` without a process group raise and name
``initialize_distributed``; a card index that does not exist raises.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.test_model_smoke import tiny_config
from tests.torch_port_helpers import port_config
from variantformer_tpu.models.init import init_seq2gene
from variantformer_tpu.parallel import launch as jax_launch
from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
from variantformer_tpu_torch.parallel import launch
from variantformer_tpu_torch.parallel.mesh import make_mesh


@pytest.fixture
def world_of_one(tmp_path, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    yield tmp_path
    launch.shutdown_distributed()


@pytest.mark.parametrize("how", ["in_process", "file_store"])
def test_initialize_distributed_is_idempotent(world_of_one, how):
    kw = {} if how == "in_process" else dict(
        init_method=f"file://{world_of_one}/store", num_processes=1, process_id=0)
    info = launch.initialize_distributed(device="cpu", **kw)
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1}
    assert dist.get_backend() == "gloo"  # the backend follows the CPU device
    assert launch.initialize_distributed(device="cpu") == info
    assert launch.rank_device() == torch.device("cpu")
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == (0, 0)
    launch.shutdown_distributed()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="does not exist"):
        launch.rank_device()  # the cached CPU device went with the group


def test_a_world_of_several_needs_a_rendezvous(world_of_one):
    with pytest.raises(ValueError, match="coordinator_address, init_method"):
        launch.initialize_distributed(num_processes=2, process_id=0, device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_shard_query_across_hosts_matches_jax(count):
    items = [f"GENE{i}" for i in range(11)]
    for index in range(count):
        assert launch.shard_query_across_hosts(items, index, count) == \
            jax_launch.shard_query_across_hosts(items, index, count)
    assert not dist.is_initialized()
    assert launch.shard_query_across_hosts(items) == items  # one process


def test_use_mesh_without_a_process_group_raises():
    cfg = tiny_config()
    proc = VCFProcessor(config=port_config(cfg), device="cpu")
    proc.set_params(jax.tree.map(np.asarray, init_seq2gene(jax.random.key(0), cfg)))
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        proc.use_mesh()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh()


@pytest.mark.parametrize("device", ["cuda:3", "cuda"])
def test_a_card_index_that_does_not_exist_raises(monkeypatch, device):
    monkeypatch.setenv("LOCAL_RANK", "5")
    with pytest.raises(RuntimeError, match="does not exist"):
        launch.rank_device(device)
    with pytest.raises(RuntimeError, match="does not exist"):
        launch.initialize_distributed(device=device)
    assert not dist.is_initialized()
