"""Seeded weights of a configuration, made on the device in a few large calls.

The tree has the nesting, names and shapes the port's parameter tree has
(``[in, out]`` linear weights, head-major packed QKV, stacked layers), and
the distributions of a fresh model: linear weights and biases uniform in
+-1/sqrt(fan_in), embeddings and the registry standard normal, LayerNorm
scales 1 and biases 0, the tissue heads' biases 0. Every uniform leaf is a
slice of ONE ``torch.rand`` draw and every normal leaf of ONE
``torch.randn`` draw from a ``torch.Generator`` seeded with the run's seed,
so the same seed gives the same weights, bit for bit, on one device and
dtype; both the program and the plain reference are handed these values.
"""

from __future__ import annotations

import math

import torch

# (path, shape, kind, scale): kind "u" = uniform(-scale, scale), "n" =
# scale * normal, "c" = the constant scale.
Leaf = tuple[tuple[str, ...], tuple[int, ...], str, float]


def _linear(path, fan_in, fan_out, lead=()) -> list[Leaf]:
    b = fan_in ** -0.5
    return [(path + ("w",), (*lead, fan_in, fan_out), "u", b),
            (path + ("b",), (*lead, fan_out), "u", b)]


def _norm(path, dim, n) -> list[Leaf]:
    return [(path + ("scale",), (n, dim), "c", 1.0), (path + ("bias",), (n, dim), "c", 0.0)]


def _layer_stack(path, n, e, f, cross: bool) -> list[Leaf]:
    out = _norm(path + ("norm1",), e, n) + _norm(path + ("norm2",), e, n)
    if cross:
        out += _norm(path + ("norm3",), e, n)
    out += _linear(path + ("mixer", "wqkv"), e, 3 * e, (n,))
    out += _linear(path + ("mixer", "out"), e, e, (n,))
    if cross:
        out += _linear(path + ("cross", "wq"), e, e, (n,))
        out += _linear(path + ("cross", "wkv"), e, 2 * e, (n,))
        out += _linear(path + ("cross", "out"), e, e, (n,))
    out += _linear(path + ("ffn_in",), e, f, (n,))
    out += _linear(path + ("ffn_out",), f // 2, e, (n,))
    return out


def _window_encoder(path, w: dict) -> list[Leaf]:
    e = w["embedding_dim"]
    return [
        (path + ("token_embedding",), (w["vocab_size"], e), "n", 1.0),
        (path + ("context_embedding",), (9, e), "n", 1.0),
        *_layer_stack(path + ("layers",), w["num_layers"], e, w["ffn_hidden_dim"],
                      w["use_context"]),
        (path + ("tissue_classifiers", "w"), (w["num_tissues"], e, w["num_classes"]), "n",
         e ** -0.5),
        (path + ("tissue_classifiers", "b"), (w["num_tissues"], w["num_classes"]), "c", 0.0),
    ]


def leaf_specs(cfg: dict) -> list[Leaf]:
    """Every leaf of the seq2gene tree of a configuration file's ``cfg``."""
    w, m = cfg["window_encoder"], cfg["seq2gene"]
    e, f = m["emb_dim"], m["ffn_hidden_dim"]
    t = m["num_tissues"] if m["multi_head"] else 1
    b = e ** -0.5
    return [
        *_window_encoder(("cre_tokenizer",), w),
        *_window_encoder(("gene_tokenizer",), w),
        *_linear(("cre_map",), m["token_dim"], e),
        *_linear(("gene_map",), m["gene_emb_dim"], e),
        (("registry",), (m["num_tissues"], e), "n", 1.0),
        (("context_embedding",), (9, e), "n", 1.0),
        *_layer_stack(("cre_layers",), m["num_layers"] - 1, e, f, True),
        *_layer_stack(("gene_layers",), m["num_layers"], e, f, True),
        (("tissue_heads", "w1"), (t, e, e), "u", b),
        (("tissue_heads", "b1"), (t, e), "c", 0.0),
        (("tissue_heads", "ln_scale"), (t, e), "c", 1.0),
        (("tissue_heads", "ln_bias"), (t, e), "c", 0.0),
        (("tissue_heads", "w2"), (t, e, e), "u", b),
        (("tissue_heads", "b2"), (t, e), "c", 0.0),
        (("tissue_heads", "w3"), (t, e, 1), "u", b),
        (("tissue_heads", "b3"), (t, 1), "c", 0.0),
    ]


def count(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaf_specs(cfg))


def make_weights(cfg: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """The seeded tree on ``device`` in ``dtype``: one draw per kind, then
    each leaf an affine map of its slice, cloned so that leaves own their
    storage (an optimizer updates them in place)."""
    specs = leaf_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sizes = {k: sum(math.prod(s) for _, s, kind, _ in specs if kind == k) for k in "un"}
    draws = {
        "u": torch.rand(sizes["u"], generator=gen, device=device, dtype=dtype),
        "n": torch.randn(sizes["n"], generator=gen, device=device, dtype=dtype),
    }
    offsets = {"u": 0, "n": 0}
    tree: dict = {}
    for path, shape, kind, scale in specs:
        n = math.prod(shape)
        if kind == "c":
            leaf = torch.full(shape, scale, device=device, dtype=dtype)
        else:
            src = draws[kind][offsets[kind]:offsets[kind] + n].view(shape)
            offsets[kind] += n
            leaf = src.mul(2 * scale).sub_(scale) if kind == "u" else src.mul(scale)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    del draws
    return tree


def tree_leaves(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, depth first in insertion order."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out += tree_leaves(v, name) if isinstance(v, dict) else [(name, v)]
    return out
