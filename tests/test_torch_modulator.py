"""The port's gene stack against the JAX package's, on the CPU.

``fused_gene_modulator`` (the whole-stack wrapper, which takes its plain
version on CPU tensors) on weights packed by the port's ``pack_gene_layers``
is held against a loop of the JAX package's ``_gene_layer`` in float32 at
1e-4 (the same algorithm, summed in another order), and against the Pallas
kernel ``fused_gene_modulator`` (interpret mode on the CPU) in bf16 at 3e-2,
which covers bf16 rounding and the kernel's tanh GELU. Only valid gene rows
(< gene_len) are compared: rows past it are never read downstream. A gene
with 832 CREs, more than the card's attention holds in one key chunk, is
held against the JAX package's XLA layers too: the reference takes it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import as_f32, port_params
from variantformer_tpu.models.core import AttnSpec as JaxSpec
from variantformer_tpu.models.init import _context_layer_stack
from variantformer_tpu.models.seq2gene import _gene_layer
from variantformer_tpu.ops.fused_modulator import fused_gene_modulator as jax_fused
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.alibi import alibi_slopes
from variantformer_tpu_torch.ops.fused_modulator import (
    fused_gene_modulator,
    fused_gene_modulator_plain,
    pack_gene_layers,
)

E, H, HD, F, LAYERS = 32, 4, 8, 64, 3
T, G1, C = 5, 9, 24

# (gene_len per donor, cre_len per donor): full, the length edges of the JAX
# package's kernel tests, and two donors with different lengths.
CASES = {
    "full": ([G1], [C]),
    "partial": ([7], [20]),
    "edge_1_2": ([1], [2]),
    "edge_3_1": ([3], [1]),
    "two_donors": ([G1, 5], [11, C]),
}


def _setup(seed, d):
    layers = _context_layer_stack(jax.random.key(seed), LAYERS, E, F)
    rng = np.random.default_rng(seed)
    gene = (rng.normal(size=(d, T, G1, E)) * 0.5).astype(np.float32)
    cre = (rng.normal(size=(LAYERS, d, C, E)) * 0.5).astype(np.float32)
    return layers, gene, cre


def _jax_layers(layers, gene, cre, gene_len, cre_len, alibi, dtype):
    slopes = jnp.asarray(alibi_slopes(H)) if alibi else None
    x = jnp.asarray(gene, dtype)
    for i in range(LAYERS):
        x = _gene_layer(
            jax.tree.map(lambda a: a[i], layers), x, jnp.asarray(cre[i], dtype),
            jnp.asarray(gene_len, jnp.int32), jnp.asarray(cre_len, jnp.int32),
            slopes, False, JaxSpec(H, HD), dtype,
        )
    return x


def _port(layers, gene, cre, gene_len, cre_len, alibi, dtype):
    packed = pack_gene_layers(port_params(layers), H, dtype)
    slopes = torch.from_numpy(alibi_slopes(H)) if alibi else None
    return fused_gene_modulator(
        torch.from_numpy(gene).to(dtype), torch.from_numpy(cre).to(dtype),
        torch.tensor(gene_len, dtype=torch.int32), torch.tensor(cre_len, dtype=torch.int32),
        packed, slopes, HD ** -0.5, H,
    )


def _assert_valid_close(out, ref, gene_len, tol):
    out, ref = as_f32(out), as_f32(ref)
    assert np.isfinite(out).all()
    for di, gl in enumerate(gene_len):
        np.testing.assert_allclose(
            out[di, :, :gl], ref[di, :, :gl], rtol=tol, atol=tol, err_msg=f"donor {di}"
        )


@pytest.mark.parametrize("alibi", [True, False], ids=["alibi", "no_alibi"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_gene_layers_f32(case, alibi):
    gene_len, cre_len = CASES[case]
    layers, gene, cre = _setup(0, len(gene_len))
    ref = _jax_layers(layers, gene, cre, gene_len, cre_len, alibi, jnp.float32)
    out = _port(layers, gene, cre, gene_len, cre_len, alibi, torch.float32)
    assert out.shape == (len(gene_len), T, G1, E)
    _assert_valid_close(out, ref, gene_len, 1e-4)


@pytest.mark.parametrize("alibi", [True, False], ids=["alibi", "no_alibi"])
@pytest.mark.parametrize("case", ["partial", "edge_1_2", "edge_3_1", "two_donors"])
def test_matches_jax_pallas_bf16(case, alibi):
    gene_len, cre_len = CASES[case]
    layers, gene, cre = _setup(1, len(gene_len))
    slopes = jnp.asarray(alibi_slopes(H)) if alibi else None
    ref = jax_fused(
        jnp.asarray(gene), jnp.asarray(cre), jnp.asarray(gene_len, jnp.int32),
        jnp.asarray(cre_len, jnp.int32), layers, slopes, HD ** -0.5, H, HD,
        tissue_block=2,
    )
    out = _port(layers, gene, cre, gene_len, cre_len, alibi, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _assert_valid_close(out, ref, gene_len, 3e-2)


def test_wrapper_is_plain_on_cpu():
    layers, gene, cre = _setup(2, 2)
    packed = pack_gene_layers(port_params(layers), H, torch.float32)
    args = (
        torch.from_numpy(gene), torch.from_numpy(cre),
        torch.tensor([G1, 4], dtype=torch.int32), torch.tensor([C, 3], dtype=torch.int32),
        packed, torch.from_numpy(alibi_slopes(H)), HD ** -0.5, H,
    )
    torch.testing.assert_close(
        fused_gene_modulator(*args), fused_gene_modulator_plain(*args), rtol=0, atol=0
    )


def test_pack_regroups_head_major_qkv():
    """Packed QKV columns are q | k | v, each heads-major, from the head-major
    (H, 3, D) layout; cross K/V likewise k | v from (H, 2, D). A head of
    HD=8 lanes takes 64 in the packs (the kernels are built for 48 and 64),
    the pad lanes zero, and so do the out-projections' matching rows."""
    layers = port_params(_context_layer_stack(jax.random.key(3), LAYERS, E, F))
    packed = pack_gene_layers(layers, H, torch.float32)
    lanes = 64
    for name, src, num in (("wqkv", layers["mixer"]["wqkv"]["w"], 3),
                           ("wckv", layers["cross"]["wkv"]["w"], 2),
                           ("wcq", layers["cross"]["wq"]["w"], 1)):
        w = src.reshape(LAYERS, E, H, num, HD)
        assert packed[name].shape == (LAYERS, E, num * H * lanes)
        for slot in range(num):
            got = packed[name][:, :, slot * H * lanes:(slot + 1) * H * lanes]
            got = got.reshape(LAYERS, E, H, lanes)
            torch.testing.assert_close(got[..., :HD], w[:, :, :, slot, :], rtol=0, atol=0)
            assert not got[..., HD:].any()
    for name, src in (("wo", layers["mixer"]["out"]["w"]), ("wco", layers["cross"]["out"]["w"])):
        got = packed[name].reshape(LAYERS, H, lanes, E)
        torch.testing.assert_close(got[:, :, :HD], src.reshape(LAYERS, H, HD, E), rtol=0, atol=0)
        assert not got[:, :, HD:].any()
    assert packed["norm1_scale"].dtype == torch.float32


def test_matches_jax_gene_layers_f32_past_the_key_chunk():
    """C = 832 CRE slots (past ATTN_MAX_KEYS, where the card walks the cross
    keys in chunks), 2 layers at E=64: the port's plain stack against the
    JAX package's XLA layers at f32, 1e-4, with one donor's CREs ending
    mid-way."""
    e, heads, layers_n, c, t, g1 = 64, 4, 2, 832, 3, 9
    hd = e // heads
    assert c > kernels.ATTN_MAX_KEYS
    layers = _context_layer_stack(jax.random.key(7), layers_n, e, 2 * e)
    rng = np.random.default_rng(7)
    gene = (rng.normal(size=(2, t, g1, e)) * 0.5).astype(np.float32)
    cre = (rng.normal(size=(layers_n, 2, c, e)) * 0.5).astype(np.float32)
    gene_len, cre_len = [g1, 5], [c, 700]
    slopes = alibi_slopes(heads)
    x = jnp.asarray(gene)
    for i in range(layers_n):
        x = _gene_layer(jax.tree.map(lambda a: a[i], layers), x, jnp.asarray(cre[i]),
                        jnp.asarray(gene_len, jnp.int32), jnp.asarray(cre_len, jnp.int32),
                        jnp.asarray(slopes), False, JaxSpec(heads, hd), jnp.float32)
    packed = pack_gene_layers(port_params(layers), heads, torch.float32)
    out = fused_gene_modulator_plain(
        torch.from_numpy(gene), torch.from_numpy(cre), torch.tensor(gene_len, dtype=torch.int32),
        torch.tensor(cre_len, dtype=torch.int32), packed, torch.from_numpy(slopes),
        hd ** -0.5, heads)
    _assert_valid_close(out, x, gene_len, 1e-4)
