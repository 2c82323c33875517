"""The CRE stack's kernel chain (``variantformer_tpu_torch/ops/cre_stack.py``)
against the loop of ``core.context_encoder_layer``.

On the CPU: the chain on the kernels' plain versions, on weights packed by
``pack_gene_layers``, equals the loop ``core.cre_loop`` at float32 (1e-5) and stays within the
stack tolerance (3e-2 of the largest value) at bf16, with suffix-padded
CRE slots, ALiBi, and head dims 48 and 32 (the latter packed to 64 lanes);
the op's CPU kernel is that chain on the plain versions, bit for bit, and
differentiable through its checkpointed layers; the forward's route takes
the loop when a gradient is wanted (of the CRE layers or of the context
embedding), on ``impl="xla"`` and in the plain forward, and the op
otherwise; the op's fake kernel gives the intermediates' shape and
passes ``torch.library.opcheck``; a CPU ``torch.export`` of the kernel
route carries ``vfx_torch::cre_stack`` and gives the direct forward's bits.

Marked ``card`` (skipped without one; on the card: ``python -m pytest
tests/test_torch_cre_stack.py -m card --noconftest``): at full v4_pcg width,
4 donors x 384 CRE slots, the card's chain against the plain loop in bf16,
and one chain launch per ``seq2gene_forward``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from variantformer_tpu_torch import bench
from variantformer_tpu_torch.api.serving import export_forward, load_exported
from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.models import core
from variantformer_tpu_torch.models import seq2gene as S
from variantformer_tpu_torch.models.init import ParamInit, init_seq2gene
from variantformer_tpu_torch.models.params import leaves
from variantformer_tpu_torch.ops import cre_stack as CS
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.alibi import alibi_slopes
from variantformer_tpu_torch.ops.fused_modulator import pack_gene_layers

H, F, LAYERS, D, C = 2, 64, 3, 2, 7
CRE_LEN = [7, 4]  # the second donor's last 3 slots are suffix padding
STACK_TOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny stacks' small operations run no faster
    on more, and the suite's other workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "tests/test_torch_cre_stack.py -m card --noconftest)")
    return torch.device("cuda")


def _stack(seed, e, device="cpu", layers=LAYERS, hidden=F):
    """Stacked CRE layers with non-trivial norms, in f32."""
    ini = ParamInit(seed, torch.device(device), torch.float32)
    tree = ini.context_layer_stack(layers, e, hidden)
    for n in ("norm1", "norm2", "norm3"):
        tree[n]["scale"] = 1.0 + 0.1 * ini.normal(tree[n]["scale"].shape)
        tree[n]["bias"] = 0.1 * ini.normal(tree[n]["bias"].shape)
    return tree


def _loop(tree, x, ctx, cre_len, slopes, head_dim, heads=H):
    """The forward's plain loop in x's dtype: the intermediates [L + 1, D, C, E]."""
    return core.cre_loop(tree, x, ctx, cre_len, slopes, core.AttnSpec(heads, head_dim), x.dtype)


def _inputs(seed, e, dtype, device="cpu", d=D, c=C):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((d, c, e), generator=gen, device=device).to(dtype)
    ctx = torch.randn((d, c, e), generator=gen, device=device).to(dtype)
    return x, ctx


def _valid_err(out, ref, cre_len):
    """Max abs difference over the valid CRE rows, and the largest |ref|."""
    err = top = 0.0
    for di, n in enumerate(cre_len):
        a, b = out[:, di, :n].float(), ref[:, di, :n].float()
        err = max(err, (a - b).abs().max().item())
        top = max(top, b.abs().max().item())
    return err, top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("head_dim", [48, 32])
def test_chain_on_plain_ops_matches_loop(head_dim, dtype):
    e = H * head_dim
    tree = _stack(1, e)
    x, ctx = _inputs(2, e, dtype)
    cre_len = torch.tensor(CRE_LEN, dtype=torch.int32)
    slopes = torch.from_numpy(alibi_slopes(H))
    packed = pack_gene_layers(tree, H, dtype)
    assert packed["wqkv"].shape[-1] == 3 * H * (64 if head_dim == 32 else head_dim)
    with torch.no_grad():
        out = CS._chain(kernels.PLAIN, x, ctx, cre_len, packed, slopes, head_dim ** -0.5, H)
        ref = _loop(tree, x, ctx, cre_len, slopes, head_dim)
    assert out.shape == (LAYERS + 1, D, C, e) and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    err, top = _valid_err(out, ref, CRE_LEN)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert err <= STACK_TOL * max(top, 1.0), (err, top)


@pytest.mark.parametrize("head_dim", [48, 32])
def test_cpu_kernel_of_the_op_is_the_loop_bit_for_bit(head_dim):
    """The op's CPU kernel is its plain version, the chain's layer loop on
    the kernels' plain versions: the same bits as ``_chain`` on
    ``kernels.PLAIN``. Under autograd the plain version (each layer
    checkpointed) gives those bits again and a gradient to every raw leaf
    through ``pack_gene_layers``."""
    e = H * head_dim
    tree = _stack(3, e)
    x, ctx = _inputs(4, e, torch.float32)
    cre_len = torch.tensor(CRE_LEN, dtype=torch.int32)
    slopes = torch.from_numpy(alibi_slopes(H))
    packed = pack_gene_layers(tree, H, torch.float32)
    with torch.no_grad():
        out = CS.cre_stack(x, ctx, cre_len, packed, slopes, H, head_dim)
        ref = CS._chain(kernels.PLAIN, x, ctx, cre_len, packed, slopes, head_dim ** -0.5, H)
    assert torch.equal(out, ref)
    raw = leaves(tree)
    for leaf in raw:
        leaf.requires_grad_(True)
    diff = CS.cre_stack_plain(x, ctx, cre_len, pack_gene_layers(tree, H, torch.float32), slopes,
                              H, head_dim)
    assert torch.equal(diff.detach(), ref)
    diff.sum().backward()
    assert all(leaf.grad is not None and torch.isfinite(leaf.grad).all() for leaf in raw)


def _tiny_cfg(head_dim=48):
    full = ModelConfig()
    return dataclasses.replace(
        full,
        window_encoder=dataclasses.replace(full.window_encoder, vocab_size=32, embedding_dim=16,
                                           num_heads=2, num_layers=1, ffn_hidden_dim=32,
                                           token_length=8),
        seq2gene=dataclasses.replace(full.seq2gene, emb_dim=H * head_dim, gene_emb_dim=16,
                                     token_dim=16, num_heads=H, num_layers=3, ffn_hidden_dim=F,
                                     num_tissues=5),
    )


def _tiny_batch(seed=0):
    b = bench.example_batch(D, C, 3, 8, 2, 32, device="cpu")
    rng = np.random.default_rng(seed)
    return b._replace(cre_count=torch.tensor(CRE_LEN, dtype=torch.int32),
                      tissue_ids=torch.from_numpy(rng.integers(0, 5, 2).astype(np.int32)))


@pytest.mark.parametrize("case", ["grad", "ctx grad", "xla", "plain", "kernel route"])
def test_route_takes_the_loop_unless_inference_on_a_kernel_route(case, monkeypatch):
    """The op is taken only for inference on a kernel route outside the
    plain forward: when the CRE layers or the context embedding want a
    gradient, on ``impl="xla"`` and in the plain forward the loop runs. On
    the CPU the op's kernel is its plain version, which counts no chain launch."""
    cfg = _tiny_cfg()
    params = init_seq2gene(cfg, 5, device="cpu")
    batch = _tiny_batch()
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return CS.cre_stack(*args)

    monkeypatch.setattr(S, "cre_stack", spy)
    kernels.reset_launches()
    if case in ("grad", "ctx grad"):
        wanted = leaves(params["cre_layers"]) if case == "grad" else [params["context_embedding"]]
        for leaf in wanted:
            leaf.requires_grad_(True)
        out = S.seq2gene_forward(params, batch, cfg)
        out.pred_expression.sum().backward()
        assert all(leaf.grad is not None and leaf.grad.abs().sum() > 0 for leaf in wanted)
    else:
        with torch.no_grad():
            if case == "plain":
                S.seq2gene_forward_plain(params, batch, cfg)
            else:
                S.seq2gene_forward(params, batch, cfg, impl="xla" if case == "xla" else "fused2")
    assert calls == ([(D, C, H * 48)] if case == "kernel route" else [])
    assert kernels.LAUNCHES["cre_stack"] == 0


def test_fake_kernel_and_opcheck():
    head_dim, e = 32, H * 32
    packed = pack_gene_layers(_stack(6, e), H, torch.float32)
    x, ctx = _inputs(7, e, torch.float32)
    args = (x, ctx, torch.tensor(CRE_LEN, dtype=torch.int32), [packed[k] for k in CS.PACKED],
            torch.from_numpy(alibi_slopes(H)), H, head_dim)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = mode.from_tensor
        out = CS.cre_stack_op(fake(x), fake(ctx), fake(args[2]), [fake(t) for t in args[3]],
                              fake(args[4]), H, head_dim)
        assert out.shape == (LAYERS + 1, D, C, e) and out.dtype == x.dtype
    torch.library.opcheck(CS.cre_stack_op, args)


def test_cpu_export_carries_the_op(tmp_path):
    cfg = _tiny_cfg(head_dim=32)
    params = init_seq2gene(cfg, 8, device="cpu")
    batch = _tiny_batch(1)
    path = export_forward(cfg, params, batch, tmp_path / "fused2.pt2", impl="fused2",
                          device="cpu")
    ops = {str(n.target) for n in torch.export.load(path).graph.nodes
           if n.op == "call_function"}
    assert "vfx_torch.cre_stack.default" in ops
    with torch.no_grad():
        direct = S.seq2gene_forward(params, batch, cfg)
    served = load_exported(path, device="cpu")(params, batch)
    for name in ("pred_expression", "pooled_embedding"):
        assert torch.equal(getattr(served, name), getattr(direct, name)), name


@pytest.mark.card
def test_card_chain_matches_plain_loop_at_full_width(card):
    """24 layers at E=1536, 32 heads of 48, 4 donors x 384 CRE slots (one
    donor suffix-padded, one with a single slot), bf16: the chain within
    the stack tolerance of the plain loop over the valid rows."""
    cfg = ModelConfig()
    mcfg = cfg.seq2gene
    e, heads, hd = mcfg.emb_dim, mcfg.num_heads, mcfg.emb_dim // mcfg.num_heads
    ini = ParamInit(0, card, torch.bfloat16)
    tree = ini.context_layer_stack(mcfg.num_layers - 1, e, mcfg.ffn_hidden_dim)
    x, ctx = _inputs(1, e, torch.bfloat16, card, d=4, c=384)
    lens = [384, 300, 1, 200]
    cre_len = torch.tensor(lens, dtype=torch.int32, device=card)
    slopes = torch.from_numpy(alibi_slopes(heads)).to(card)
    packed = pack_gene_layers(tree, heads, torch.bfloat16)
    kernels.reset_launches()
    with torch.inference_mode():
        out = CS.cre_stack(x, ctx, cre_len, packed, slopes, heads, hd)
        ref = _loop(tree, x, ctx, cre_len, slopes, hd, heads)
    assert kernels.LAUNCHES["cre_stack"] == 1
    # the chain's host launches: made by an eager call or a capture, none
    # by a replay of a graph captured before (ops/graphs.py)
    replayed_only = kernels.GRAPHS["cre_stack"]["replays"] > kernels.GRAPHS["cre_stack"]["captures"]
    # six GEMMs a layer, and the FFN-in with its GeGLU (F / 2 = 1024) fused
    assert kernels.LAUNCHES["gemm_bf16"] == (0 if replayed_only else 6 * (mcfg.num_layers - 1))
    assert kernels.LAUNCHES["gemm_geglu"] == (0 if replayed_only else mcfg.num_layers - 1)
    assert kernels.LAUNCHES["geglu"] == 0
    err, top = _valid_err(out, ref, lens)
    print(f"cre_stack chain vs plain loop, full width: max abs err {err:.5g} "
          f"(largest |ref| {top:.5g})")
    assert err <= STACK_TOL * max(top, 1.0), (err, top)


@pytest.mark.card
def test_card_one_chain_launch_per_forward(card):
    cfg = ModelConfig()
    params = bench.packed_params(cfg, init_seq2gene(cfg, 0, device=card, dtype=torch.bfloat16))
    batch = bench.example_batch(2, 64, 8, cfg.dataset.max_length, 3,
                                cfg.window_encoder.vocab_size, device=card)
    kernels.reset_launches()
    with torch.inference_mode():
        for n in (1, 2):
            out = S.seq2gene_forward(params, batch, cfg)
            assert kernels.LAUNCHES["cre_stack"] == n
    assert torch.isfinite(out.pred_expression).all()
