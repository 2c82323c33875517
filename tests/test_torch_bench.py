"""The port's bench entry (``variantformer_tpu_torch/bench.py``) on the CPU.

Its batch must be the root bench's (``__graft_entry__._example_batch``):
the same shapes, dtypes and values. Its weights are packed as
``VCFProcessor.set_params`` packs them. It runs on the card only: without
one ``main()`` raises before any work.
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch
from tests.test_model_smoke import tiny_config
from tests.torch_port_helpers import port_config
from variantformer_tpu_torch import bench
from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
from variantformer_tpu_torch.models.init import init_seq2gene


@pytest.mark.parametrize("d,c,g,length,t,vocab,seed", [
    (4, 384, 200, 200, 54, 500, 0),  # the bench's batch
    (1, 3, 2, 7, 5, 32, 0),
    (2, 5, 4, 8, 3, 64, 11),
])
def test_example_batch_equals_the_root_bench_batch(d, c, g, length, t, vocab, seed):
    want = _example_batch(d, c, g, length, t, vocab, rng_seed=seed)
    got = bench.example_batch(d, c, g, length, t, vocab, rng_seed=seed, device="cpu")
    set_leaves = {name: leaf for name, leaf in want._asdict().items() if leaf is not None}
    assert set(set_leaves) == {name for name in got._fields if getattr(got, name) is not None}
    for name, leaf in set_leaves.items():
        ref = np.asarray(leaf)
        mine = getattr(got, name)
        assert isinstance(mine, torch.Tensor) and mine.device.type == "cpu", name
        assert mine.dtype == torch.int32 and ref.dtype == np.int32, name
        assert tuple(mine.shape) == ref.shape, name
        np.testing.assert_array_equal(mine.numpy(), ref, err_msg=name)


def test_packed_params_match_set_params():
    cfg = port_config(tiny_config())
    params = bench.packed_params(cfg, init_seq2gene(cfg, 3, device="cpu"))
    proc = VCFProcessor(config=cfg, device="cpu")
    proc.set_params(init_seq2gene(cfg, 3, device="cpu"))
    for key in ("gene_layers_packed", "cre_layers_packed"):
        for leaf, want in proc._params[key].items():
            assert torch.equal(params[key][leaf], want), leaf
    for tok in ("cre_tokenizer", "gene_tokenizer"):
        for leaf, want in proc._params[tok]["layers_packed"].items():
            assert torch.equal(params[tok]["layers_packed"][leaf], want), (tok, leaf)


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "init_seq2gene", lambda *a, **k: pytest.fail("ran without a card"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main()
