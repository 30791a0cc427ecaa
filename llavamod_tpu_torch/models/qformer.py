"""Query-former and conv-block token-compressing projectors (port of
llavamod_tpu/models/qformer.py).

  * qformer{L}_{Q} / cheap_qformer{L}_{Q} (reference qformer.py:9-205):
    proj_in MLP -> Q learned query tokens -> L BERT-style blocks (self-attn
    over the queries, cross-attn into the image features every layer,
    GELU MLP with ratio 2.6875, post-LN, eps 1e-12) -> proj_out MLP.
    "cheap" keeps the trunk at the vision width and projects up to the LLM
    width only at the output.
  * simple_in{I}_out{O} / cheap_simple_in{I}_out{O} (simple_block.py:39-121):
    proj_in MLP -> 2x2 average pool (576 -> 144) -> I x [residual 3x3 conv
    + ViT block] -> 3x3 VALID conv (12x12 -> 10x10 = 100 tokens) -> O x
    blocks -> proj_out MLP.

State-dict keys are the JAX tree's paths ('layers.0.cross_attn.k.kernel',
'blocks_in.0.conv.conv.kernel', ...).  The conv kernels keep the JAX HWIO
layout [3, 3, D, D] and are permuted for `F.conv2d`.  The JAX simple tree
also holds two Python leaves, each conv's `same` flag and each ViT block's
`heads`; here they are module attributes, and `tree_scalars` gives them
back for the tree-layout mm_projector.bin (train/checkpoint.py).  All
attention here is the plain version, as the JAX package pins `impl="xla"`
(qformer.py:74); GELU is exact.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from llavamod_tpu_torch.models.params import Initializer, ParamGroup
from llavamod_tpu_torch.models.projector import (
    Projector,
    _apply_dense,
    _dense,
)
from llavamod_tpu_torch.ops.attention import dot_product_attention
from llavamod_tpu_torch.ops.norms import layer_norm

_QF_MLP_RATIO = 2.6875  # reference qformer.py:107 ("intermediate_size")


def _qf_heads(width: int) -> int:
    """Blip2QFormer head count: 32 (reference qformer.py:122), else the
    largest power-of-two divisor for toy widths that 32 does not divide."""
    for h in (32, 16, 8, 4, 2):
        if width % h == 0:
            return h
    return 1


def _proj_mlp(ini: Initializer, din: int, dmid: int, dout: int) -> nn.Module:
    m = nn.Module()
    m.fc1 = _dense(ini, din, dmid)
    m.fc2 = _dense(ini, dmid, dout)
    return m


def _proj_mlp_apply(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return _apply_dense(p.fc2, F.gelu(_apply_dense(p.fc1, x),
                                      approximate="none"))


def _ln(ini: Initializer, d: int) -> ParamGroup:
    return ParamGroup(weight=ini.ones(d), bias=ini.zeros(d))


def _ln_apply(p: ParamGroup, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p.weight, p.bias, 1e-12)


def _attn(ini: Initializer, d: int, kv_dim: int = 0) -> nn.Module:
    kv_dim = kv_dim or d
    m = nn.Module()
    m.q, m.k = _dense(ini, d, d), _dense(ini, kv_dim, d)
    m.v, m.o = _dense(ini, kv_dim, d), _dense(ini, d, d)
    return m


def _attn_apply(p: nn.Module, x_q: torch.Tensor, x_kv: torch.Tensor,
                heads: int) -> torch.Tensor:
    b, tq, d = x_q.shape
    dh = d // heads
    q = _apply_dense(p.q, x_q).reshape(b, tq, heads, dh)
    k = _apply_dense(p.k, x_kv).reshape(b, x_kv.shape[1], heads, dh)
    v = _apply_dense(p.v, x_kv).reshape(b, x_kv.shape[1], heads, dh)
    out = dot_product_attention(q, k, v, causal=False, impl="xla")
    return _apply_dense(p.o, out.reshape(b, tq, d))


def _in_out(ini: Initializer, cheap: bool, vision_dim: int, llm_dim: int):
    if cheap:
        return (_proj_mlp(ini, vision_dim, vision_dim, vision_dim),
                _proj_mlp(ini, vision_dim, llm_dim, llm_dim))
    return (_proj_mlp(ini, vision_dim, llm_dim, llm_dim),
            _proj_mlp(ini, llm_dim, llm_dim, llm_dim))


def build_qformer_projector(spec: str, vision_dim: int, llm_dim: int,
                            num_layers: int, num_queries: int,
                            cheap: bool = False) -> Projector:
    width = vision_dim if cheap else llm_dim
    inter = int(width * _QF_MLP_RATIO)
    heads = _qf_heads(width)

    def init(generator, device=None, dtype=torch.float32) -> nn.Module:
        ini = Initializer(generator, device, dtype)
        m = nn.Module()
        m.proj_in, m.proj_out = _in_out(ini, cheap, vision_dim, llm_dim)
        m.queries = nn.Parameter(ini.zeros(num_queries, width))
        # Blip2QFormerModel.layernorm on the query embeddings before layer 0
        m.ln_embed = _ln(ini, width)
        layers = []
        for _ in range(num_layers):
            lp = nn.Module()
            lp.self_attn, lp.ln_self = _attn(ini, width), _ln(ini, width)
            lp.cross_attn, lp.ln_cross = _attn(ini, width), _ln(ini, width)
            lp.mlp, lp.ln_mlp = _proj_mlp(ini, width, inter, width), _ln(
                ini, width)
            layers.append(lp)
        m.layers = nn.ModuleList(layers)
        return m

    def apply(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """x: [B, N, vision_dim] -> [B, Q, llm_dim]."""
        img = _proj_mlp_apply(p.proj_in, x)
        h = _ln_apply(p.ln_embed, p.queries.expand(x.shape[0], -1, -1))
        for lp in p.layers:
            # post-LN (BERT) residual blocks, cross-attention every layer
            h = _ln_apply(lp.ln_self,
                          h + _attn_apply(lp.self_attn, h, h, heads))
            h = _ln_apply(lp.ln_cross,
                          h + _attn_apply(lp.cross_attn, h, img, heads))
            h = _ln_apply(lp.ln_mlp, h + _proj_mlp_apply(lp.mlp, h))
        return _proj_mlp_apply(p.proj_out, h)

    return Projector(spec, init, apply, lambda n: num_queries)


# ---------------------------------------------------------------------------
# simple conv/ViT token reducer
# ---------------------------------------------------------------------------

def _conv3x3(ini: Initializer, d: int, same: bool) -> ParamGroup:
    g = ParamGroup(kernel=ini.normal((3, 3, d, d), (9 * d) ** -0.5),
                   bias=ini.zeros(d))
    g.same = same
    return g


def _conv3x3_apply(p: ParamGroup, x_grid: torch.Tensor) -> torch.Tensor:
    """x_grid: [B, H, W, D] (NHWC), kernel HWIO, as the JAX conv."""
    out = F.conv2d(x_grid.permute(0, 3, 1, 2), p.kernel.permute(3, 2, 0, 1),
                   padding=1 if p.same else 0)
    return out.permute(0, 2, 3, 1) + p.bias


def _to_grid(x: torch.Tensor) -> torch.Tensor:
    b, n, d = x.shape
    g = math.isqrt(n)
    return x.reshape(b, g, g, d)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    b, h, w, d = x.shape
    return x.reshape(b, h * w, d)


def _vit_block(ini: Initializer, d: int, heads: int,
               mlp_ratio: float) -> nn.Module:
    m = nn.Module()
    m.ln1, m.attn = _ln(ini, d), _attn(ini, d)
    m.ln2, m.mlp = _ln(ini, d), _proj_mlp(ini, d, int(d * mlp_ratio), d)
    m.heads = heads
    return m


def _vit_block_apply(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    h = _ln_apply(p.ln1, x)
    x = x + _attn_apply(p.attn, h, h, p.heads)
    return x + _proj_mlp_apply(p.mlp, _ln_apply(p.ln2, x))


def _res_conv(ini: Initializer, d: int) -> nn.Module:
    m = nn.Module()
    m.norm, m.conv = _ln(ini, d), _conv3x3(ini, d, True)
    return m


def _res_conv_apply(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    g = _to_grid(x)
    h = F.gelu(_conv3x3_apply(p.conv, _ln_apply(p.norm, g)),
               approximate="none")
    return _to_tokens(g + h)


def _block(ini: Initializer, d: int, heads: int, mlp_ratio: float):
    m = nn.Module()
    m.conv, m.vit = _res_conv(ini, d), _vit_block(ini, d, heads, mlp_ratio)
    return m


def build_simple_projector(spec: str, vision_dim: int, llm_dim: int,
                           num_in: int, num_out: int,
                           cheap: bool = False) -> Projector:
    width = vision_dim if cheap else llm_dim
    # reference SimpleBlock num_heads=32 (simple_block.py:40)
    heads = _qf_heads(width)
    mlp_ratio = 4.0 if cheap else _QF_MLP_RATIO

    def init(generator, device=None, dtype=torch.float32) -> nn.Module:
        ini = Initializer(generator, device, dtype)
        m = nn.Module()
        m.proj_in, m.proj_out = _in_out(ini, cheap, vision_dim, llm_dim)
        m.blocks_in = nn.ModuleList([_block(ini, width, heads, mlp_ratio)
                                     for _ in range(num_in)])
        if num_out > 0:
            m.down2 = _conv3x3(ini, width, False)
        m.blocks_out = nn.ModuleList([_block(ini, width, heads, mlp_ratio)
                                      for _ in range(num_out)])
        return m

    def apply(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
        x = _proj_mlp_apply(p.proj_in, x)
        g = _to_grid(x)                                   # 2x2 average pool
        b, hh, ww, d = g.shape
        x = _to_tokens(g.reshape(b, hh // 2, 2, ww // 2, 2, d).mean(dim=(2, 4)))
        for blk in p.blocks_in:
            x = _vit_block_apply(blk.vit, _res_conv_apply(blk.conv, x))
        if hasattr(p, "down2"):
            x = _to_tokens(_conv3x3_apply(p.down2, _to_grid(x)))
            for blk in p.blocks_out:
                x = _vit_block_apply(blk.vit, _res_conv_apply(blk.conv, x))
        return _proj_mlp_apply(p.proj_out, x)

    def n_out(n: int) -> int:
        g = math.isqrt(n) // 2
        if num_out > 0:
            g -= 2  # 3x3 VALID conv
        return g * g

    return Projector(spec, init, apply, n_out)


def tree_scalars(projector_type: str,
                 state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The Python leaves of the JAX simple-projector tree, keyed as the
    state dict (each conv's `same`, each ViT block's `heads`), as the JAX
    tree-layout mm_projector.bin stores them (0-d bool and int64 tensors);
    {} for every other projector."""
    if not re.match(r"^(cheap_)?simple_in\d+_out\d+$", projector_type):
        return {}
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if k.endswith(".conv.conv.kernel"):
            out[k[:-len("kernel")] + "same"] = torch.tensor(True)
        elif k == "down2.kernel":
            out["down2.same"] = torch.tensor(False)
        elif k.endswith(".vit.ln1.weight"):
            out[k[:-len("ln1.weight")] + "heads"] = torch.tensor(
                _qf_heads(v.shape[0]))
    return out
