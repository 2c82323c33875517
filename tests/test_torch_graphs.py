"""The graph cache of the inference ops (``variantformer_tpu_torch/ops/graphs.py``).

On the CPU the cache captures with a stub in place of ``CudaGraph``: its
capture runs the chain once and keeps the output, and its replay runs the
chain again on the static inputs and writes the result into that output,
as a graph's replay writes into its own memory. Held: the key tells apart
shapes, dtypes, strides, scalars and weight pointers; the first call of an
op runs eagerly, a miss captures once and a hit replays; the least recently
used graph is evicted at the bound; ``kernels.GRAPHS`` counts captures,
replays and evictions; an output never aliases the graph's memory; an op's
graphs share one static buffer an input; calls inside a capture, under
grad, and the ops' CPU kernels bypass the cache, the last bit for bit the
plain versions. The ops' CUDA kernels, which launch the kernels' plain
versions on CPU tensors, replay through the stub with the eager chain's bits
and capture anew after a weight swap.

Marked ``card`` (skipped without one; on the card: ``python -m pytest
tests/test_torch_graphs.py -m card --noconftest``): the CRE stack's replays
bitwise equal to its eager chain at full v4_pcg width.
"""

import pytest
import torch

from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.models.init import ParamInit
from variantformer_tpu_torch.ops import cre_stack as CS
from variantformer_tpu_torch.ops import fused_encoder as FE
from variantformer_tpu_torch.ops import fused_modulator as FM
from variantformer_tpu_torch.ops import graphs, kernels
from variantformer_tpu_torch.ops.alibi import alibi_slopes

H, HD, LAYERS, FFN = 2, 48, 2, 64
E = H * HD


class StubGraph:
    """A graph that runs its chain: capture keeps the output, replay writes
    the chain's new result into it."""

    made: list = []

    def __init__(self, device):
        self.device = device
        self.replays = 0
        StubGraph.made.append(self)

    def capture(self, chain):
        self.chain = chain
        self.output = chain()
        return self.output

    def replay(self):
        self.replays += 1
        self.output.copy_(self.chain())


@pytest.fixture
def stub(monkeypatch):
    StubGraph.made.clear()
    monkeypatch.setattr(graphs, "graph_factory", StubGraph)
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache())
    kernels.reset_launches()
    yield StubGraph
    kernels.reset_launches()


def _chain(w):
    """A toy chain: inputs (x [N, K], lens [N] int32), weight w [K, M]."""
    return lambda x, lens: x @ w + lens[:, None].to(x.dtype)


def _inputs(n=4, k=3, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, k), generator=gen).to(dtype), torch.arange(n, dtype=torch.int32)


def _run(cache, w, x, lens, scalars=(1,), op="cre_stack"):
    with torch.no_grad():
        return cache.run(op, _chain(w), (x, lens), [w], scalars)


def _counts(op="cre_stack"):
    return dict(kernels.GRAPHS[op])


@pytest.mark.parametrize("change", ["same", "shape", "dtype", "strides", "scalars", "weights"])
def test_key_tells_apart_shapes_dtypes_strides_scalars_and_weights(stub, change):
    cache = graphs.GraphCache()
    w = torch.randn(3, 5)
    x, lens = _inputs()
    _run(cache, w, x, lens)   # the first call: eager
    _run(cache, w, x, lens)   # captured
    assert _counts()["captures"] == 1
    w2, x2, lens2, scalars = w, x, lens, (1,)
    if change == "shape":
        x2, lens2 = _inputs(n=6)
    elif change == "dtype":
        x2, w2 = x.double(), w.double()
    elif change == "strides":
        x2 = torch.randn(3, 4).t()
    elif change == "scalars":
        scalars = (2,)
    elif change == "weights":
        w2 = w.clone()
    out = _run(cache, w2, x2, lens2, scalars)
    assert torch.equal(out, _chain(w2)(x2, lens2))
    assert _counts()["captures"] == (1 if change == "same" else 2)
    assert _counts()["replays"] == 2


def test_first_call_is_eager_then_a_miss_captures_once_and_hits_replay(stub):
    cache = graphs.GraphCache()
    w = torch.randn(3, 5)
    outs = []
    for seed in range(4):
        x, lens = _inputs(seed=seed)
        outs.append((_run(cache, w, x, lens), _chain(w)(x, lens)))
        want = [(0, 0), (1, 1), (1, 2), (1, 3)][seed]
        assert (_counts()["captures"], _counts()["replays"]) == want, seed
    assert len(stub.made) == 1 and stub.made[0].replays == 3
    for got, want in outs:   # each replay read its own call's inputs
        assert torch.equal(got, want)
    assert _counts()["evictions"] == 0


def test_lru_eviction_at_the_bound(stub):
    cache = graphs.GraphCache(bound=2)
    w = torch.randn(3, 5)
    shapes = {n: _inputs(n=n) for n in (2, 3, 4)}
    _run(cache, w, *shapes[2])    # eager
    for n in (2, 3, 4):           # three captures: the third evicts n=2
        _run(cache, w, *shapes[n])
    assert _counts() == {"captures": 3, "replays": 3, "evictions": 1}
    _run(cache, w, *shapes[3])    # a hit: n=3 becomes the most recent
    assert _counts() == {"captures": 3, "replays": 4, "evictions": 1}
    _run(cache, w, *shapes[2])    # captured again: evicts n=4, not n=3
    assert _counts() == {"captures": 4, "replays": 5, "evictions": 2}
    _run(cache, w, *shapes[3])
    assert _counts() == {"captures": 4, "replays": 6, "evictions": 2}
    _run(cache, w, *shapes[4])
    assert _counts() == {"captures": 5, "replays": 7, "evictions": 3}


def test_output_does_not_alias_the_graphs_memory(stub):
    cache = graphs.GraphCache()
    w = torch.randn(3, 5)
    _run(cache, w, *_inputs(seed=0))
    x1, lens1 = _inputs(seed=1)
    first = _run(cache, w, x1, lens1)
    kept = first.clone()
    second = _run(cache, w, *_inputs(seed=2))
    graph = stub.made[0]
    assert first.data_ptr() != graph.output.data_ptr() != second.data_ptr()
    assert torch.equal(first, kept) and not torch.equal(first, second)
    # the inputs were copied: changing the caller's tensor changes no output
    x1.add_(1.0)
    assert torch.equal(first, kept)


def test_an_ops_graphs_share_one_static_buffer_an_input(stub):
    cache = graphs.GraphCache()
    w = torch.randn(3, 5)
    big, small = _inputs(n=8), _inputs(n=2)
    _run(cache, w, *big)
    for inputs in (big, small, big, small):
        assert torch.equal(_run(cache, w, *inputs), _chain(w)(*inputs))
    first, second = stub.made
    assert first.chain is not second.chain
    state = cache._devices[torch.device("cpu")]
    (big_entry, small_entry) = state.entries.values()
    for a, b in zip(big_entry.inputs, small_entry.inputs):
        assert a.data_ptr() == b.data_ptr()   # the smaller signature is a view
    # a larger signature grows the buffer; the graphs made before keep theirs
    larger = _inputs(n=16)
    assert torch.equal(_run(cache, w, *larger), _chain(w)(*larger))
    assert torch.equal(_run(cache, w, *small), _chain(w)(*small))
    assert state.slabs[("cre_stack", 0)].numel() == 16 * 3 * 4


@pytest.mark.parametrize("case", ["capture", "grad"])
def test_calls_inside_a_capture_or_under_grad_bypass_the_cache(stub, monkeypatch, case):
    cache = graphs.GraphCache()
    w = torch.randn(3, 5)
    x, lens = _inputs()
    _run(cache, w, x, lens)
    if case == "capture":
        monkeypatch.setattr(graphs, "capturing", lambda device: True)
        outs = [_run(cache, w, x, lens) for _ in range(2)]
    else:
        wg = w.clone().requires_grad_(True)
        with torch.enable_grad():
            outs = [cache.run("cre_stack", _chain(wg), (x, lens), [wg], (1,)) for _ in range(2)]
        outs[0].sum().backward()
        assert wg.grad is not None
    assert not stub.made and _counts() == {"captures": 0, "replays": 0, "evictions": 0}
    for out in outs:
        torch.testing.assert_close(out.detach(), _chain(w)(x, lens), rtol=0, atol=0)


def _cre_args(seed, device="cpu", c=5):
    ini = ParamInit(seed, torch.device(device), torch.float32)
    packed = FM.pack_gene_layers(ini.context_layer_stack(LAYERS, E, FFN), H, torch.float32)
    x, ctx = ini.normal((2, c, E)), ini.normal((2, c, E))
    return (x, ctx, torch.tensor([c, 2], dtype=torch.int32), [packed[k] for k in CS.PACKED],
            torch.from_numpy(alibi_slopes(H)), H, HD)


def _encoder_args(seed, n=3, length=6):
    ini = ParamInit(seed, torch.device("cpu"), torch.float32)
    packed = FE.pack_encoder_layers(ini.plain_layer_stack(LAYERS, E, FFN), H, torch.float32)
    return (ini.normal((n, length, E)), torch.tensor([length, 2, 1][:n], dtype=torch.int32),
            [packed[k] for k in FE.PACKED], torch.from_numpy(alibi_slopes(H)), HD ** -0.5, H)


def _modulator_args(seed, t=2, g1=4, c=5):
    ini = ParamInit(seed, torch.device("cpu"), torch.float32)
    packed = FM.pack_gene_layers(ini.context_layer_stack(LAYERS, E, FFN), H, torch.float32)
    return (ini.normal((2, t, g1, E)), ini.normal((LAYERS, 2, c, E)),
            torch.tensor([g1, 2], dtype=torch.int32), torch.tensor([c, 1], dtype=torch.int32),
            [packed[k] for k in FM.PACKED], torch.from_numpy(alibi_slopes(H)), HD ** -0.5, H)


def _eager_cre(x, ctx, cre_len, packed, slopes, heads, hd):
    return CS._chain(kernels.KERNELS, x, ctx, cre_len, dict(zip(CS.PACKED, packed)), slopes,
                     hd ** -0.5, heads)


def _eager_encoder(x, tok_len, packed, slopes, scale, heads):
    return FE._chain(kernels.KERNELS, x, tok_len, dict(zip(FE.PACKED, packed)), slopes, scale,
                     heads)


def _eager_modulator(gs, cre, gene_len, cre_len, packed, slopes, scale, heads):
    return FM._chain(kernels.KERNELS, gs, cre, gene_len, cre_len, dict(zip(FM.PACKED, packed)),
                     slopes, scale, heads)


def _plain_cre(x, ctx, cre_len, packed, *rest):
    return CS.cre_stack_plain(x, ctx, cre_len, dict(zip(CS.PACKED, packed)), *rest)


def _plain_encoder(x, tok_len, packed, *rest):
    return FE.fused_window_encoder_plain(x, tok_len, dict(zip(FE.PACKED, packed)), *rest)


def _plain_modulator(gs, cre, gene_len, cre_len, packed, *rest):
    return FM.fused_gene_modulator_plain(gs, cre, gene_len, cre_len,
                                         dict(zip(FM.PACKED, packed)), *rest)


# name: (op, its CUDA kernel, its arguments from a seed, index of the packed
# weights among them, the eager chain, the plain version)
OPS = {
    "cre_stack": (CS.cre_stack_op, CS._cre_stack_cuda, _cre_args, 3, _eager_cre, _plain_cre),
    "fused_window_encoder": (FE.window_encoder_op, FE._window_encoder_cuda, _encoder_args, 2,
                             _eager_encoder, _plain_encoder),
    "fused_gene_modulator": (FM.gene_modulator_op, FM._gene_modulator_cuda, _modulator_args, 4,
                             _eager_modulator, _plain_modulator),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_cpu_kernels_of_the_ops_bypass_the_cache(stub, name):
    """On CPU tensors the op runs its CPU kernel, the plain version: no
    graph, no launch counted, and the plain version's bits."""
    op, _, make, _, _, plain = OPS[name]
    args = make(0)
    with torch.no_grad():
        outs = [op(*args) for _ in range(3)]
        want = plain(*args)
    assert all(torch.equal(out, want) for out in outs)
    assert not stub.made and all(not any(c.values()) for c in kernels.GRAPHS.values())
    assert kernels.LAUNCHES[name] == 0


@pytest.mark.parametrize("name", sorted(OPS))
def test_cuda_kernels_of_the_ops_replay_the_eager_bits(stub, name):
    """The ops' CUDA kernels, given CPU tensors (their kernel wrappers then
    run the plain versions), through the stub: the first call eager, then
    one capture and replays with the eager chain's bits on each call's
    inputs, and a new capture for a new weight set; every call counted in
    LAUNCHES."""
    _, cuda_kernel, make, at, eager, _ = OPS[name]
    args = make(1)
    with torch.no_grad():
        first = cuda_kernel(*args)
        assert not stub.made and torch.equal(first, eager(*args))
        for seed in (2, 3):   # other inputs of the same signature
            call = (*make(seed)[:at], *args[at:])
            assert torch.equal(cuda_kernel(*call), eager(*call)), seed
        assert _counts(name) == {"captures": 1, "replays": 2, "evictions": 0}
        assert torch.equal(cuda_kernel(*args), first)
        swapped = (*args[:at], make(4)[at], *args[at + 1:])
        assert torch.equal(cuda_kernel(*swapped), eager(*swapped))
    assert _counts(name) == {"captures": 2, "replays": 4, "evictions": 0}
    assert kernels.LAUNCHES[name] == 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "tests/test_torch_graphs.py -m card --noconftest)")
    return torch.device("cuda")


@pytest.mark.card
def test_card_cre_stack_replays_are_the_eager_bits(card):
    mc = ModelConfig().seq2gene
    e, heads, hd = mc.emb_dim, mc.num_heads, mc.emb_dim // mc.num_heads
    ini = ParamInit(0, card, torch.bfloat16)
    packed = FM.pack_gene_layers(ini.context_layer_stack(mc.num_layers - 1, e, mc.ffn_hidden_dim),
                                 heads, torch.bfloat16)
    slopes = torch.from_numpy(alibi_slopes(heads)).to(card)
    layers = [packed[k] for k in CS.PACKED]
    kernels.reset_launches()
    with torch.inference_mode():
        for c, lens in ((384, [384, 300, 1, 2]), (64, [64, 10, 1, 33]), (384, [3, 384, 200, 9])):
            x, ctx = ini.normal((4, c, e)), ini.normal((4, c, e))
            cre_len = torch.tensor(lens, dtype=torch.int32, device=card)
            eager = CS._chain(kernels.KERNELS, x, ctx, cre_len, packed, slopes, hd ** -0.5, heads)
            got = CS.cre_stack_op(x, ctx, cre_len, layers, slopes, heads, hd)
            assert torch.equal(got, eager), (c, lens)
    assert kernels.GRAPHS["cre_stack"]["replays"] >= 2
