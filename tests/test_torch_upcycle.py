"""Dense -> sparse upcycling of the port (llavamod_tpu_torch/models/llm/
upcycle.py) against the JAX package's: the same MoE config, and the same
leaves (experts copied from the dense FFN, a zero router)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from util_torch_port import flatten_numpy, to_jax_llm

from llavamod_tpu.models.llm import decoder as jdecoder
from llavamod_tpu.models.llm.upcycle import upcycle as jupcycle
from llavamod_tpu_torch.interop.from_jax import (
    load_jax_params,
    numpy_from_state_dict,
)
from llavamod_tpu_torch.models.llm import decoder as tdecoder
from llavamod_tpu_torch.models.llm.config import tiny_config
from llavamod_tpu_torch.models.llm.upcycle import upcycle


@pytest.mark.parametrize("kw", [
    dict(moe_mode="sparse"),
    dict(moe_mode="dense", num_experts=3, top_k=1, use_residual=True),
    dict(moe_layers_idx=(1, 2), capacity_factor=1.25, min_capacity=2,
         router_aux_loss_coef=0.02),
], ids=["sparse", "dense-residual", "explicit"])
def test_upcycle_matches_jax(kw):
    cfg = tiny_config(num_layers=3)
    jparams = jdecoder.init(to_jax_llm(cfg), jax.random.PRNGKey(0))
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    load_jax_params(model, jax.device_get(jparams))
    before = numpy_from_state_dict(model)

    jcfg, jmoe = jupcycle(to_jax_llm(cfg), jparams, **kw)
    tcfg, tmoe = upcycle(cfg, model, **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = flatten_numpy(jax.device_get(jmoe))
    got = numpy_from_state_dict(tmoe)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    # the dense module is left as it was, and the MoE one runs
    after = numpy_from_state_dict(model)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    with torch.inference_mode():
        out = tmoe(input_ids=torch.randint(1, 100, (1, 9)))
    assert torch.isfinite(out.hidden).all()
    assert len(out.moe_losses) == len(tcfg.moe_layers)


@pytest.mark.parametrize("layers", [(), (0, 3), (-1,), (0, 1, 2, 2)])
def test_upcycle_refuses_layers_the_decoder_lacks(layers):
    cfg = tiny_config(num_layers=3)
    model = tdecoder.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        upcycle(cfg, model, moe_layers_idx=layers)
