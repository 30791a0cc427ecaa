"""The port's modules against the JAX package with the same weights
(carried through llavamod_tpu_torch/interop/from_jax.py): the state-dict
paths, the ViT, the projectors, and llava.forward on tiny_config with 4
experts on layer 0.  f32, tolerance 1e-4 on non-pad rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from util_torch_port import (
    jax_batch,
    matched_llava,
    multimodal_arrays,
    np32,
    tiny_llava_config,
    to_jax_vision,
)

from llavamod_tpu.models import llava as jllava
from llavamod_tpu.models import projector as jprojector
from llavamod_tpu.models.vision import vit as jvit
from llavamod_tpu_torch.interop.from_jax import (
    load_jax_params,
    state_dict_from_numpy,
)
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models import projector as tprojector
from llavamod_tpu_torch.models.vision import vit as tvit

TOL = 1e-4


def test_state_dict_keys_are_the_jax_paths():
    cfg = tiny_llava_config()
    jcfg, params, model = matched_llava(cfg)
    keys = set(state_dict_from_numpy(jax.device_get(params)))
    assert keys == set(model.state_dict())
    assert "llm.layers.0.mlp.experts.up" in keys
    assert "llm.layers.1.attn.wq" in keys
    assert "projector.layers.1.kernel" in keys
    assert model.state_dict()["llm.layers.0.mlp.experts.up"].shape == (4, 64, 128)
    assert model.state_dict()["llm.lm_head.weight"].shape == (512, 64)


def test_bf16_leaves_convert_bit_exactly():
    x = jnp.asarray(np.random.RandomState(0).randn(3, 5), jnp.bfloat16)
    t = state_dict_from_numpy({"w": np.asarray(x)})["w"]
    assert t.dtype == torch.bfloat16
    assert (t.float().numpy() == np.asarray(x.astype(jnp.float32))).all()


@pytest.mark.parametrize("select_layer", [-2, -1])
def test_vit_forward_and_select_features(select_layer):
    from llavamod_tpu_torch.models.vision.vit import tiny_vision_config

    cfg = tiny_vision_config()
    params = jvit.init(to_jax_vision(cfg), jax.random.PRNGKey(3))
    model = tvit.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(model, jax.device_get(params))
    px = np.random.RandomState(4).randn(2, 3, 28, 28).astype(np.float32)
    jh = jvit.forward(params, to_jax_vision(cfg), jnp.asarray(px), select_layer)
    with torch.inference_mode():
        th = tvit.forward(model, cfg, torch.tensor(px), select_layer)
    np.testing.assert_allclose(np32(th), np32(jh), rtol=TOL, atol=TOL)
    assert tvit.select_features(cfg, th).shape == (2, cfg.num_patches, 32)


@pytest.mark.parametrize("spec", ["linear", "mlp2x_gelu", "mlp3x_gelu",
                                  "identity"])
def test_projectors(spec):
    d_in, d_out = (16, 16) if spec == "identity" else (16, 24)
    jp = jprojector.build_projector(spec, d_in, d_out)
    tp = tprojector.build_projector(spec, d_in, d_out)
    params = jp.init(jax.random.PRNGKey(5))
    mod = tp.init(torch.Generator().manual_seed(0))
    load_jax_params(mod, jax.device_get(params))
    x = np.random.RandomState(6).randn(2, 9, d_in).astype(np.float32)
    with torch.inference_mode():
        out = tp.apply(mod, torch.tensor(x))
    np.testing.assert_allclose(np32(out), np32(jp.apply(params, jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    assert tp.num_output_tokens(576) == jp.num_output_tokens(576)


def test_llava_forward_matches_jax():
    cfg = tiny_llava_config()
    jcfg, params, model = matched_llava(cfg)
    arrays = multimodal_arrays(cfg, [14, 7], 16, with_image=[True, False])
    jo = jllava.forward(params, jcfg, jax_batch(arrays))
    with torch.inference_mode():
        to = tllava.forward(model, cfg, tllava.MultimodalBatch(
            **{k: torch.as_tensor(v) for k, v in arrays.items()}))
    real = arrays["segment_ids"].astype(bool)
    np.testing.assert_allclose(np32(to.hidden)[real], np32(jo.hidden)[real],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np32(to.aux_loss), np32(jo.aux_loss),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np32(to.router_probs[0]),
                               np32(jo.router_probs[0]), rtol=TOL, atol=TOL)
    jl = jllava.logits(params, jcfg, jo.hidden[:, -1:])
    with torch.inference_mode():
        tl = tllava.logits(model, cfg, to.hidden[:, -1:])
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=TOL, atol=TOL)
