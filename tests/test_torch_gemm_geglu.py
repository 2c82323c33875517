"""The FFN-in projection with its GeGLU in one op (``kernels.gemm_geglu``),
on the CPU.

The fused kernel (layout 3 of ``csrc/gemm_sm90.cu``) runs only on the card,
where ``chip_smoke.py`` holds it bit for bit against ``geglu(gemm(...))``.
Held here: ``Ops`` carries the op on both bundles; its plain version is
``geglu_plain(gemm_plain(...))`` bit for bit at f32 and bf16; the three
forward chains (window encoder, gene stack, CRE stack) call it once a layer
and give, on ``kernels.PLAIN``, the bits of the chain that ran ``gemm`` then
``geglu``; and the wrapper's route on a tensor that says it is on the card:
one launch of layout 3 where F / 2 is a multiple of 128, ``gemm`` then
``geglu`` elsewhere (the kernel is stood in for by its plain version).
"""

import numpy as np
import pytest
import torch

from variantformer_tpu_torch.models.init import ParamInit
from variantformer_tpu_torch.ops import cre_stack as CS
from variantformer_tpu_torch.ops import fused_encoder as FE
from variantformer_tpu_torch.ops import fused_modulator as FM
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.alibi import alibi_slopes

H, HD, LAYERS, FFN = 2, 48, 3, 64
E = H * HD


def _operands(m, k, f, dtype, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(dtype)
    return t(m, k), t(k, f, scale=k ** -0.5), t(f, scale=0.5)


def test_ops_bundle_the_fused_ffn_in_on_both_routes():
    assert kernels.KERNELS.gemm_geglu is kernels.gemm_geglu
    assert kernels.PLAIN.gemm_geglu is kernels.gemm_geglu_plain
    assert kernels.LAUNCHES["gemm_geglu"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m, k, f", [(7, 16, 32), (200, 72, 512), (33, 48, 96)])
def test_plain_version_is_gemm_then_geglu_bit_for_bit(dtype, m, k, f):
    a, w, bias = _operands(m, k, f, dtype)
    want = kernels.geglu_plain(kernels.gemm_plain(a, w, bias))
    for got in (kernels.PLAIN.gemm_geglu(a, w, bias), kernels.gemm_geglu(a, w, bias)):
        assert got.dtype == dtype and tuple(got.shape) == (m, f // 2)
        assert torch.equal(got, want)
    assert torch.equal(kernels.gemm_geglu(a, w), kernels.geglu_plain(kernels.gemm_plain(a, w)))


class _Counted:
    """``kernels.PLAIN`` with its ops' calls counted by name."""

    def __init__(self, ops):
        self.calls: dict = {}
        wrap = lambda name, fn: lambda *a, **k: (
            self.calls.__setitem__(name, self.calls.get(name, 0) + 1), fn(*a, **k))[1]
        self.ops = ops._replace(**{name: wrap(name, fn) for name, fn in ops._asdict().items()})


# The chains as they were before the FFN-in took its GeGLU along: gemm, then geglu.
TWO_OPS = kernels.PLAIN._replace(
    gemm_geglu=lambda a, w, bias=None: kernels.PLAIN.geglu(kernels.PLAIN.gemm(a, w, bias)))


def _encoder(ops, dtype):
    ini = ParamInit(1, torch.device("cpu"), dtype)
    packed = FE.pack_encoder_layers(ini.plain_layer_stack(LAYERS, E, FFN), H, dtype)
    x = ini.normal((3, 6, E))
    tok_len = torch.tensor([6, 2, 1], dtype=torch.int32)
    return FE._chain(ops, x, tok_len, packed, torch.from_numpy(alibi_slopes(H)), HD ** -0.5, H)


def _gene_stack(ops, dtype):
    ini = ParamInit(2, torch.device("cpu"), dtype)
    packed = FM.pack_gene_layers(ini.context_layer_stack(LAYERS, E, FFN), H, dtype)
    gs, cre = ini.normal((2, 2, 4, E)), ini.normal((LAYERS, 2, 5, E))
    return FM._chain(ops, gs, cre, torch.tensor([4, 2], dtype=torch.int32),
                     torch.tensor([5, 1], dtype=torch.int32), packed,
                     torch.from_numpy(alibi_slopes(H)), HD ** -0.5, H)


def _cre_chain(ops, dtype):
    ini = ParamInit(3, torch.device("cpu"), dtype)
    packed = FM.pack_gene_layers(ini.context_layer_stack(LAYERS, E, FFN), H, dtype)
    x, ctx = ini.normal((2, 5, E)), ini.normal((2, 5, E))
    return CS._chain(ops, x, ctx, torch.tensor([5, 2], dtype=torch.int32), packed,
                     torch.from_numpy(alibi_slopes(H)), HD ** -0.5, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", [_encoder, _gene_stack, _cre_chain])
def test_forward_chains_on_plain_keep_the_two_op_bits(chain, dtype):
    counted = _Counted(kernels.PLAIN)
    with torch.no_grad():
        got = chain(counted.ops, dtype)
        want = chain(TWO_OPS, dtype)
    assert counted.calls.get("gemm_geglu") == LAYERS
    assert "geglu" not in counted.calls
    assert got.dtype == dtype and torch.equal(got, want)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the wrapper takes
    its card route (with its launches stood in for)."""

    @property
    def is_cuda(self):
        return True


def _on_card(*ts):
    return [t.as_subclass(_OnCard) for t in ts]


def _off_card(*ts):
    return [None if t is None else t.as_subclass(torch.Tensor) for t in ts]


@pytest.fixture
def stand_ins(monkeypatch):
    """The fused launch, ``gemm`` and ``geglu`` replaced by recorders that
    compute their plain versions."""
    calls = []

    def launch(name, a, b, bias, res, out, m, n, k, layout):
        calls.append(("launch", name, layout, m, n, k))
        out.copy_(kernels.gemm_geglu_plain(*_off_card(a, b, bias)))

    def gemm(a, w, bias=None, residual=None):
        calls.append(("gemm", tuple(w.shape)))
        return kernels.gemm_plain(*_off_card(a, w, bias), residual)

    def geglu(f):
        calls.append(("geglu", tuple(f.shape)))
        return kernels.geglu_plain(f)

    monkeypatch.setattr(kernels, "_gemm_sm90", launch)
    monkeypatch.setattr(kernels, "gemm", gemm)
    monkeypatch.setattr(kernels, "geglu", geglu)
    return calls


@pytest.mark.parametrize("f", [256, 512, 2048])
def test_wrapper_fuses_where_the_halves_are_whole_tiles(stand_ins, f):
    m, k = 300, 64
    a, w, bias = _operands(m, k, f, torch.bfloat16, seed=f)
    out = kernels.gemm_geglu(*_on_card(a, w, bias))
    assert stand_ins == [("launch", "gemm_geglu", 3, m, f, k)]
    assert kernels.gemm_plan(m, f, k).tiles_n * kernels.GEGLU_BLOCK_N == f // 2
    assert torch.equal(out, kernels.gemm_geglu_plain(a, w, bias))


@pytest.mark.parametrize("f", [64, 192, 384, 1000])
def test_wrapper_runs_two_launches_where_f_half_is_not_whole_tiles(stand_ins, f):
    """F / 2 % 128 != 0: ``gemm`` then ``geglu``, no fused launch."""
    m, k = 40, 32
    a, w, bias = _operands(m, k, f, torch.bfloat16, seed=f)
    out = kernels.gemm_geglu(*_on_card(a, w, bias))
    assert stand_ins == [("gemm", (k, f)), ("geglu", (m, f))]
    assert torch.equal(out, kernels.gemm_geglu_plain(a, w, bias))
