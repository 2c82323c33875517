"""The plain reference of the seq2gene model: float32 PyTorch, one gene at a time.

Written from the published equations of czi-ai/variantformer's combined
modulator (``model_combined_modulator.py``) and seq2reg window encoder, with
no kernel, no padding and no batching across genes: every gene is run on its
own valid windows and CREs only, so no mask stands in for a count. Inside a
window set the windows keep their token lengths as key masks.

  window encoder  x = E[tokens]; per layer h = SA(LN1 x) + x,
                  x = FFN(LN2 h) + x; mean over the valid tokens
  maps            cre = cre_emb W_c + b, gene = gene_emb W_g + b
  CRE layer       h = SA(LN1 x) + x, h2 = CA(LN2 h, ctx) + h,
                  x' = FFN(LN3 h2) + x     (ctx = class embedding per CRE)
  gene layer i    h = SA(LN1 g) + g, h2 = CA(LN2 h, cre_i) + h,
                  g' = FFN(LN3 h2) + g     (cre_0 = the mapped CREs,
                                            cre_i = CRE layer i's output)
  heads           softplus(W3 GELU(W2 GELU(LN(W1 g[registry]))))

SA is self-attention with symmetric ALiBi (-slope_h |i - j|), CA attends
without a position bias, FFN is GeGLU (value * erf-GELU(gate)). The gene
stream of a tissue is its registry token followed by the gene windows.

``Matmul`` does every product: in float32 with TF32 off (the reference), or
with both operands rounded to float8 e4m3 under a per-tensor scale and then
multiplied in float32 (the control: the precision below the served bf16).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (Press et al., 2022), interleaved for head
    counts that are not a power of two."""

    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(num_heads).is_integer():
        return np.asarray(pow2(num_heads), np.float32)
    closest = 2 ** math.floor(math.log2(num_heads))
    extra = alibi_slopes(2 * closest)[0::2][: num_heads - closest]
    return np.asarray(pow2(closest) + list(extra), np.float32)


def strict_fp32() -> None:
    """No TF32 anywhere: float32 products are float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Matmul:
    """``a @ b`` in float32, or through float8 e4m3 operands (``fp8=True``)."""

    FP8_MAX = 448.0

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().clamp(min=1e-12) / self.FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()  # rounded forward, straight-through backward

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.fp8:
            a, b = self._q(a), self._q(b)
        return torch.matmul(a, b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.fp8:
            a, b = self._q(a), self._q(b)
        return torch.einsum(eq, a, b)


class Seq2GeneReference:
    """The forward of one gene in float32 from a parameter tree (any dtype;
    read as float32). ``cfg`` is a configuration file's dict."""

    def __init__(self, cfg: dict, params: dict, fp8: bool = False, remat: bool = False,
                 window_block: int = 256):
        self.cfg = cfg
        self.p = params
        self.mm = Matmul(fp8)
        self.remat = remat
        self.window_block = window_block
        w, m = cfg["window_encoder"], cfg["seq2gene"]
        self.enc_heads = w["num_heads"]
        self.heads = m["num_heads"]
        dev = params["registry"].device
        self.enc_slopes = torch.from_numpy(alibi_slopes(w["num_heads"])).to(dev)
        self.slopes = torch.from_numpy(alibi_slopes(m["num_heads"])).to(dev)

    # -- blocks -------------------------------------------------------------
    def linear(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x, p["w"]) + p["b"].float()

    @staticmethod
    def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], p["scale"].float(), p["bias"].float(), eps)

    def ffn(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.linear(p["ffn_in"], x).chunk(2, dim=-1)
        return self.linear(p["ffn_out"], value * F.gelu(gate))

    def attention(self, q, k, v, heads: int, slopes, key_len=None) -> torch.Tensor:
        """q [B, Sq, H*D], k/v [B, Sk, H*D] -> [B, Sq, H*D]; ``slopes``
        adds -slope |i - j|; ``key_len`` [B] masks keys at or past it."""
        b, sq, hd = q.shape
        sk = k.shape[1]
        d = hd // heads
        q = q.reshape(b, sq, heads, d)
        k = k.reshape(b, sk, heads, d)
        v = v.reshape(b, sk, heads, d)
        s = self.mm.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
        if slopes is not None:
            pos = torch.arange(max(sq, sk), device=q.device, dtype=torch.float32)
            dist = (pos[:sq, None] - pos[None, :sk]).abs()
            s = s - slopes[None, :, None, None] * dist
        if key_len is not None:
            valid = torch.arange(sk, device=q.device)[None, :] < key_len[:, None]
            s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        w = torch.softmax(s, dim=-1)
        return self.mm.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, sq, hd)

    def self_block(self, p, x, heads, slopes, key_len=None):
        e = x.shape[-1]
        qkv = self.linear(p["wqkv"], x).reshape(*x.shape[:-1], heads, 3, e // heads)
        q, k, v = (qkv[..., i, :].reshape(*x.shape[:-1], e) for i in range(3))  # head-major
        return self.linear(p["out"], self.attention(q, k, v, heads, slopes, key_len))

    def cross_block(self, p, x, ctx, heads):
        """x [B, Sq, E] attends to ctx [B, Sk, E] or, shared by the B rows,
        [1, Sk, E] (no position bias)."""
        e = x.shape[-1]
        d = e // heads
        q = self.linear(p["wq"], x)
        kv = self.linear(p["wkv"], ctx).reshape(*ctx.shape[:-1], heads, 2, d)
        k, v = (kv[..., i, :].reshape(*ctx.shape[:-1], e).expand(x.shape[0], -1, -1)
                for i in range(2))
        return self.linear(p["out"], self.attention(q, k, v, heads, None))

    @staticmethod
    def layer(stack: dict, i: int) -> dict:
        return {k: Seq2GeneReference.layer(v, i) if isinstance(v, dict) else v[i]
                for k, v in stack.items()}

    def _maybe_remat(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # -- stages -------------------------------------------------------------
    def encode_windows(self, enc: dict, tokens: torch.Tensor, tok_len: torch.Tensor):
        """[N, L] tokens, [N] valid counts -> [N, E] mean-pooled embeddings,
        in blocks of windows."""
        out = []
        for lo in range(0, tokens.shape[0], self.window_block):
            tk, tl = tokens[lo:lo + self.window_block], tok_len[lo:lo + self.window_block]
            x = enc["token_embedding"].float()[tk.long()]
            layers = enc["layers"]
            for i in range(layers["norm1"]["scale"].shape[0]):
                x = self._maybe_remat(self._window_layer, self.layer(layers, i), x, tl)
            valid = (torch.arange(x.shape[1], device=x.device)[None, :] < tl[:, None]).float()
            out.append((x * valid[:, :, None]).sum(1) / tl.clamp(min=1).float()[:, None])
        return torch.cat(out)

    def _window_layer(self, p, x, tok_len):
        h = self.self_block(p["mixer"], self.layer_norm(p["norm1"], x), self.enc_heads,
                            self.enc_slopes, tok_len) + x
        return self.ffn(p, self.layer_norm(p["norm2"], h)) + x

    def _cre_layer(self, p, x, ctx):
        h = self.self_block(p["mixer"], self.layer_norm(p["norm1"], x), self.heads,
                            self.slopes) + x
        h2 = self.cross_block(p["cross"], self.layer_norm(p["norm2"], h), ctx, self.heads) + h
        return self.ffn(p, self.layer_norm(p["norm3"], h2)) + x

    def _gene_layer(self, p, g, cre):
        """g [T, G1, E]; cre [1, C, E] shared by the tissues."""
        h = self.self_block(p["mixer"], self.layer_norm(p["norm1"], g), self.heads,
                            self.slopes) + g
        h2 = self.cross_block(p["cross"], self.layer_norm(p["norm2"], h), cre, self.heads) + h
        return self.ffn(p, self.layer_norm(p["norm3"], h2)) + g

    def heads_mlp(self, pooled: torch.Tensor) -> torch.Tensor:
        p = self.p["tissue_heads"]
        h = self.mm(pooled, p["w1"][0]) + p["b1"][0].float()
        h = F.gelu(self.layer_norm({"scale": p["ln_scale"][0], "bias": p["ln_bias"][0]}, h))
        h = F.gelu(self.mm(h, p["w2"][0]) + p["b2"][0].float())
        return F.softplus((self.mm(h, p["w3"][0]) + p["b3"][0].float())[..., 0])

    def forward_gene(self, cre_tokens, cre_tok_len, cre_labels, gene_tokens, gene_tok_len,
                     tissue_ids) -> tuple[torch.Tensor, torch.Tensor]:
        """One gene's valid windows -> (pred [T], pooled embedding [T, E])."""
        p = self.p
        cre = self.linear(p["cre_map"], self.encode_windows(p["cre_tokenizer"], cre_tokens,
                                                            cre_tok_len))
        gene = self.linear(p["gene_map"], self.encode_windows(p["gene_tokenizer"],
                                                              gene_tokens, gene_tok_len))
        t, e = tissue_ids.shape[0], gene.shape[-1]
        reg = p["registry"].float()[tissue_ids.long()]
        g = torch.cat([reg[:, None, :], gene[None].expand(t, *gene.shape)], dim=1)
        ctx = p["context_embedding"].float()[cre_labels.long()][None]
        x = cre[None]
        cre_layers, gene_layers = p["cre_layers"], p["gene_layers"]
        n_gene = gene_layers["norm1"]["scale"].shape[0]
        for i in range(n_gene):
            g = self._maybe_remat(self._gene_layer, self.layer(gene_layers, i), g, x)
            if i + 1 < n_gene:
                x = self._maybe_remat(self._cre_layer, self.layer(cre_layers, i), x, ctx)
        pooled = g[:, 0, :]
        return self.heads_mlp(pooled), pooled


def poisson_nll(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.PoissonNLLLoss(log_input=False, full=True, eps=1e-8) per
    element: pred - target log(pred + eps), plus Stirling's term where
    target > 1."""
    loss = pred - target * torch.log(pred + 1e-8)
    stirling = target * torch.log(target) - target + 0.5 * torch.log(2 * math.pi * target)
    return loss + torch.where(target > 1, stirling, torch.zeros_like(stirling))
