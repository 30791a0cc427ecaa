"""Helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Both sides get the same inputs, made with numpy from a seed, and the same
weights: a JAX param tree is initialised with the JAX package and carried
into the port's module leaf for leaf (llavamod_tpu_torch/interop/from_jax).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from llavamod_tpu.models import llava as jllava
from llavamod_tpu.models.llava import LlavaConfig as JLlavaConfig
from llavamod_tpu.models.llm.config import DecoderConfig as JDecoderConfig
from llavamod_tpu.models.vision.vit import VisionConfig as JVisionConfig
from llavamod_tpu_torch.interop.from_jax import (
    load_jax_params,
    state_dict_from_numpy,
)
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models.llava import LlavaConfig
from llavamod_tpu_torch.models.llm.config import tiny_config
from llavamod_tpu_torch.models.vision.vit import tiny_vision_config

torch.set_num_threads(2)


def to_jax_llm(cfg) -> JDecoderConfig:
    return JDecoderConfig(**dataclasses.asdict(cfg))


def to_jax_vision(cfg) -> JVisionConfig:
    return JVisionConfig(**dataclasses.asdict(cfg))


def to_jax_llava(cfg: LlavaConfig) -> JLlavaConfig:
    rest = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("llm", "vision")}
    return JLlavaConfig(llm=to_jax_llm(cfg.llm),
                        vision=to_jax_vision(cfg.vision), **rest)


def tiny_llava_config(**llm_kw) -> LlavaConfig:
    kw = dict(moe_num_experts=4, moe_layers=(0,))
    kw.update(llm_kw)
    return LlavaConfig(llm=tiny_config(**kw), vision=tiny_vision_config(),
                       projector_type="mlp2x_gelu", max_images=1)


def randomize_routers(params, seed: int = 1):
    """The fresh JAX router is zero (uniform routing); give it seeded values
    so the top-2 choice is exercised."""
    rng = np.random.RandomState(seed)
    for layer in params["llm"]["layers"]:
        if "router" in layer["mlp"]:
            r = layer["mlp"]["router"]
            layer["mlp"]["router"] = jax.numpy.asarray(
                rng.randn(*r.shape).astype(np.float32))
    return params


def matched_llava(cfg: LlavaConfig, seed: int = 0):
    """(jax_cfg, jax params, torch model) holding the same weights."""
    jcfg = to_jax_llava(cfg)
    params = randomize_routers(jllava.init(jcfg, jax.random.PRNGKey(seed)))
    model = tllava.init(cfg, torch.Generator().manual_seed(seed))
    load_jax_params(model, jax.device_get(params))
    return jcfg, params, model


def multimodal_arrays(cfg: LlavaConfig, lengths, t: int, seed: int = 0,
                      with_image=None):
    """Left-padded multimodal batch as numpy arrays: row i has lengths[i]
    real tokens at the end, the first `num_image_tokens` of which are image
    slots when with_image[i]."""
    rng = np.random.RandomState(seed)
    b = len(lengths)
    n_img = cfg.num_image_tokens
    with_image = with_image or [True] * b
    s = cfg.vision.image_size
    ids = rng.randint(1, cfg.llm.vocab_size, (b, t)).astype(np.int32)
    seg = np.zeros((b, t), np.int32)
    mask = np.zeros((b, t), bool)
    pos = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        seg[i, t - n:] = 1
        ids[i, :t - n] = 0
        if with_image[i]:
            st = t - n + 1
            mask[i, st:st + n_img] = True
            pos[i, st:st + n_img] = i * n_img + np.arange(n_img)
            ids[i, st:st + n_img] = 0
    return dict(
        input_ids=ids, segment_ids=seg, image_mask=mask, image_pos=pos,
        pixels=rng.randn(b, 1, 3, s, s).astype(np.float32),
        pixel_valid=np.asarray(with_image, bool)[:, None])


def jax_batch(arrays):
    import jax.numpy as jnp

    return jllava.MultimodalBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def torch_batch(arrays):
    return tllava.MultimodalBatch(**{k: torch.as_tensor(v)
                                     for k, v in arrays.items()})


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def flatten_numpy(tree) -> dict:
    """A JAX tree (after jax.device_get) -> flat {'a.b.0.c': f32 ndarray},
    keyed as the port's state_dict."""
    return {k: v.float().numpy() for k, v in state_dict_from_numpy(tree).items()}
