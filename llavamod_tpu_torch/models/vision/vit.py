"""Vision transformer encoder, CLIP-ViT and SigLIP in one implementation
(port of llavamod_tpu/models/vision/vit.py).

Patchify as reshape + one matmul, optional class token, learned position
embeddings, pre-LN blocks, feature selection from an intermediate layer.
The attention runs the plain version on purpose, as the JAX package pins it
(vit.py:197-199).  The tower is frozen: its output is detached.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from llavamod_tpu_torch.utils.registry import Registry
from llavamod_tpu_torch.models.params import Initializer, ParamGroup
from llavamod_tpu_torch.ops.attention import dot_product_attention
from llavamod_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str = "clip-vit-l-336"
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    use_class_token: bool = True      # CLIP yes, SigLIP no
    use_pre_layernorm: bool = True    # CLIP yes, SigLIP no
    activation: str = "quick_gelu"    # quick_gelu | gelu_tanh
    layer_norm_eps: float = 1e-5
    patch_bias: bool = True

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_class_token else 0)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


vision_configs: Registry[VisionConfig] = Registry("vision config")

CLIP_VIT_L_336 = VisionConfig()
vision_configs.register("clip-vit-l-336", CLIP_VIT_L_336,
                        aliases=("openai/clip-vit-large-patch14-336", "openai", "laion"))


def tiny_vision_config(**kw) -> VisionConfig:
    base = dict(name="tiny-vit", image_size=28, patch_size=14, hidden_size=32,
                intermediate_size=64, num_layers=2, num_heads=4)
    base.update(kw)
    return VisionConfig(**base)


def _ln(ini: Initializer, d: int) -> ParamGroup:
    return ParamGroup(weight=ini.ones(d), bias=ini.zeros(d))


def _dense(ini: Initializer, din: int, dout: int) -> ParamGroup:
    return ParamGroup(kernel=ini.dense(din, dout), bias=ini.zeros(dout))


class VisionTower(nn.Module):
    """Parameters under the JAX names: patch_embed, pos_embed, class_token,
    pre_ln, layers.{i}.{ln1, attn.{q,k,v,o}, ln2, mlp.{fc1,fc2}}, post_ln."""

    def __init__(self, cfg: VisionConfig, *, generator: torch.Generator,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        ini = Initializer(generator, device, dtype)
        d = cfg.hidden_size
        patch = {"kernel": ini.normal((cfg.patch_size ** 2 * 3, d), 0.02)}
        if cfg.patch_bias:
            patch["bias"] = ini.zeros(d)
        self.patch_embed = ParamGroup(**patch)
        self.pos_embed = nn.Parameter(ini.normal((cfg.seq_len, d), d ** -0.5))
        if cfg.use_class_token:
            self.class_token = nn.Parameter(ini.normal((d,), d ** -0.5))
        if cfg.use_pre_layernorm:
            self.pre_ln = _ln(ini, d)
        layers = []
        for _ in range(cfg.num_layers):
            blk = nn.Module()
            blk.ln1 = _ln(ini, d)
            blk.attn = nn.ModuleDict({n: _dense(ini, d, d) for n in "qkvo"})
            blk.ln2 = _ln(ini, d)
            blk.mlp = nn.ModuleDict({
                "fc1": _dense(ini, d, cfg.intermediate_size),
                "fc2": _dense(ini, cfg.intermediate_size, d)})
            layers.append(blk)
        self.layers = nn.ModuleList(layers)
        self.post_ln = _ln(ini, d)
        self.requires_grad_(False)  # the tower is frozen

    def forward(self, pixels: torch.Tensor, select_layer: int = -2) -> torch.Tensor:
        return forward(self, self.cfg, pixels, select_layer)


def init(cfg: VisionConfig, generator: torch.Generator, device=None,
         dtype=torch.float32) -> VisionTower:
    return VisionTower(cfg, generator=generator, device=device, dtype=dtype)


def _act(cfg: VisionConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return nn.functional.gelu(x, approximate="tanh")


def patchify(cfg: VisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, 3, H, W] -> patches [B, N, P*P*3] (row-major patch grid)."""
    b, c, hh, ww = pixels.shape
    p = cfg.patch_size
    g = hh // p
    x = pixels.reshape(b, c, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, g * g, c * p * p)


def _dense_apply(p: ParamGroup, x: torch.Tensor) -> torch.Tensor:
    return x @ p.kernel + p.bias


def forward(model: VisionTower, cfg: VisionConfig, pixels: torch.Tensor,
            select_layer: int = -2) -> torch.Tensor:
    """pixels: [B, 3, S, S] -> hidden states [B, seq, D] of the selected
    layer (HF hidden_states indexing: -2 = all but the last block)."""
    b = pixels.shape[0]
    pe = model.patch_embed
    x = patchify(cfg, pixels.to(pe.kernel.dtype)) @ pe.kernel
    if cfg.patch_bias:
        x = x + pe.bias
    if cfg.use_class_token:
        cls = model.class_token.to(x.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
    x = x + model.pos_embed
    if cfg.use_pre_layernorm:
        x = layer_norm(x, model.pre_ln.weight, model.pre_ln.bias,
                       cfg.layer_norm_eps)

    num_blocks = (cfg.num_layers + select_layer + 1 if select_layer < 0
                  else select_layer)
    if not 0 <= num_blocks <= cfg.num_layers:
        raise ValueError(f"select_layer {select_layer} out of range")
    h, dh = cfg.num_heads, cfg.head_dim
    for layer in model.layers[:num_blocks]:
        ln1 = layer_norm(x, layer.ln1.weight, layer.ln1.bias, cfg.layer_norm_eps)
        a = layer.attn
        q = _dense_apply(a["q"], ln1).reshape(b, -1, h, dh)
        k = _dense_apply(a["k"], ln1).reshape(b, -1, h, dh)
        v = _dense_apply(a["v"], ln1).reshape(b, -1, h, dh)
        attn = dot_product_attention(q, k, v, causal=False, impl="xla")
        x = x + _dense_apply(a["o"], attn.reshape(b, -1, cfg.hidden_size))
        ln2 = layer_norm(x, layer.ln2.weight, layer.ln2.bias, cfg.layer_norm_eps)
        m = layer.mlp
        x = x + _dense_apply(m["fc2"], _act(cfg, _dense_apply(m["fc1"], ln2)))
    return x


def select_features(cfg: VisionConfig, hidden: torch.Tensor,
                    select_feature: str = "patch") -> torch.Tensor:
    """Drop/keep the CLS token."""
    if not cfg.use_class_token:
        return hidden
    if select_feature == "patch":
        return hidden[:, 1:]
    if select_feature == "cls_patch":
        return hidden
    raise ValueError(f"Unexpected select feature: {select_feature}")
