"""The port's differentiable gene stack against the JAX package's gradients,
on the CPU, at the shapes of ``tests/test_fused_modulator_vjp.py``.

``fused_gene_modulator_diff`` (checkpointing forward, recompute backward;
its plain version on CPU tensors) gives d(gene_stream),
d(cre_intermediates) (through the cross K/V projection, outside the
kernels) and every layer leaf, ``wkv`` included. They are held against
``jax.grad`` of a loop of the JAX ``_gene_layer`` at float32 (rel L2 < 1e-4
per leaf: the same algorithm, summed in another order), and against
``jax.grad`` through the Pallas ``fused_gene_modulator_diff`` (interpret
mode) in bf16 (rel L2 < 5e-2, the bound of the JAX package's own VJP test;
the Pallas backward uses the tanh GELU derivative). Pad gene rows and
masked CRE slots get exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import port_params
from variantformer_tpu.models.core import AttnSpec
from variantformer_tpu.models.init import _context_layer_stack
from variantformer_tpu.models.seq2gene import _gene_layer
from variantformer_tpu.ops.alibi import alibi_slopes
from variantformer_tpu.ops.fused_modulator import fused_gene_modulator_diff as jax_diff
from variantformer_tpu_torch.ops import fused_modulator as FM

E, H, HD, F, L = 32, 4, 8, 64, 3
T, G1, C, DN = 5, 9, 24, 2
SCALE = HD ** -0.5
GENE_LENS, CRE_LENS = [G1, 5], [C, 11]


def _setup(seed):
    layers = _context_layer_stack(jax.random.key(seed), L, E, F)
    rng = np.random.default_rng(seed)
    gene = (rng.normal(size=(DN, T, G1, E)) * 0.5).astype(np.float32)
    cre = (rng.normal(size=(L, DN, C, E)) * 0.5).astype(np.float32)
    w = rng.normal(size=(DN, T, G1, E)).astype(np.float32)
    for di in range(DN):
        w[di, :, GENE_LENS[di]:] = 0.0  # pad gene rows carry no loss
    return layers, gene, cre, w


def _keyed(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _port(layers, gene, cre, w, dtype):
    """Port gradients of sum(out * w): (d gene, d cre, {leaf key: grad})."""
    tl = port_params(layers)
    leaves = [FM.get_leaf(tl, p).requires_grad_(True) for p in FM.LEAVES]
    g = torch.from_numpy(gene).to(dtype).requires_grad_(True)
    c = torch.from_numpy(cre).to(dtype).requires_grad_(True)
    out = FM.fused_gene_modulator_diff(
        g, c, torch.tensor(GENE_LENS), torch.tensor(CRE_LENS), tl,
        torch.from_numpy(np.asarray(alibi_slopes(H))), SCALE, H,
    )
    grads = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), [g, c] + leaves)
    keys = ["".join(f"['{k}']" for k in p) for p in FM.LEAVES]
    as_np = lambda t: t.float().numpy()
    return as_np(grads[0]), as_np(grads[1]), {k: as_np(t) for k, t in zip(keys, grads[2:])}


def _check(got, want, tol):
    dg, dc, dl = got
    wg, wc, wl = want
    assert set(dl) == set(wl)
    for name, a, b in [("gene", dg, wg), ("cre", dc, wc)] + [(k, dl[k], wl[k]) for k in wl]:
        rel = _rel(a, b)
        assert rel < tol, f"{name}: rel L2 {rel}"


def test_grads_match_jax_xla_f32():
    layers, gene, cre, w = _setup(3)
    slopes = jnp.asarray(alibi_slopes(H))

    def loss(gene, cre, layers):
        x = gene
        for i in range(L):
            x = _gene_layer(jax.tree.map(lambda a: a[i], layers), x, cre[i],
                            jnp.asarray(GENE_LENS), jnp.asarray(CRE_LENS), slopes, False,
                            AttnSpec(H, HD), jnp.float32)
        return jnp.sum(x * w)

    wg, wc, wl = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(gene), jnp.asarray(cre), layers)
    _check(_port(layers, gene, cre, w, torch.float32),
           (np.asarray(wg), np.asarray(wc), _keyed(wl)), 1e-4)


@pytest.mark.mid
def test_grads_match_jax_pallas_diff_bf16():
    layers, gene, cre, w = _setup(3)
    slopes = jnp.asarray(alibi_slopes(H))

    def loss(gene, cre, layers):
        out = jax_diff(gene, cre, jnp.asarray(GENE_LENS), jnp.asarray(CRE_LENS), layers, slopes,
                       SCALE, H, HD, 2)
        return jnp.sum(out.astype(jnp.float32) * w)

    wg, wc, wl = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(gene), jnp.asarray(cre), layers)
    _check(_port(layers, gene, cre, w, torch.bfloat16),
           (np.asarray(wg), np.asarray(wc), _keyed(wl)), 5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_gene_rows_and_masked_cre_slots_get_exact_zeros(dtype):
    layers, gene, cre, w = _setup(4)
    dg, dc, _ = _port(layers, gene, cre, w, dtype)
    for di in range(DN):
        assert np.abs(dg[di, :, GENE_LENS[di]:]).max(initial=0.0) == 0.0, f"donor {di} rows"
        assert np.abs(dg[di, :, :GENE_LENS[di]]).max() > 0
        assert np.abs(dc[:, di, CRE_LENS[di]:]).max(initial=0.0) == 0.0, f"donor {di} slots"
        assert np.abs(dc[:, di, :CRE_LENS[di]]).max() > 0
