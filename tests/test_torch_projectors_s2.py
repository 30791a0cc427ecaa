"""The port's Q-Former and simple projectors (llavamod_tpu_torch/models/
qformer.py), the S2 tower (models/vision/s2.py) and their checkpoint
layouts against the JAX package's, on the CPU at tiny widths, with the JAX
weights carried over leaf for leaf:

  * qformer2_32, cheap_qformer2_32, simple_in2_out2, cheap_simple_in2_out2:
    outputs at 1e-5 (f32; the attention and the conv run in another
    order), output token counts equal;
  * the Q-Former against transformers' `Blip2QFormerModel` through the
    exported Blip2 keys (the reference's module), at 2e-5 / 1e-4 as the
    JAX package's own oracle test;
  * the bicubic resize against `jax.image.resize` (up 12 -> 24, 14 -> 42,
    down 24 -> 10 with antialias), at 1e-5, and its distance to
    `F.interpolate(mode="bicubic")`, which is another function;
    `multiscale_forward` at (28, 56) and (28, 56, 84) against JAX's at 1e-5;
  * mm_projector.bin both ways: the port reads JAX's files and JAX the
    port's, bitwise, for the Q-Former (Blip2 keys) and the pool / simple
    projectors (the tree layout, the simple tree's Python leaves included);
  * the Q-Former's HF layout both ways, bitwise JAX's."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from util_torch_port import np32

import jax
import jax.numpy as jnp

from llavamod_tpu.interop import hf as jhf
from llavamod_tpu.models.projector import build_projector as jbuild_projector
from llavamod_tpu.models.vision import vit as jvit
from llavamod_tpu.models.vision.s2 import multiscale_forward as jmultiscale
from llavamod_tpu.models.vision.vit import VisionConfig as JVisionConfig
from llavamod_tpu.train import checkpoint as jckpt
from llavamod_tpu_torch.interop import hf
from llavamod_tpu_torch.interop.from_jax import load_jax_params
from llavamod_tpu_torch.models.projector import build_projector
from llavamod_tpu_torch.models.qformer import _qf_heads
from llavamod_tpu_torch.models.vision import vit as tvit
from llavamod_tpu_torch.models.vision.s2 import (
    multiscale_forward,
    resize_bicubic,
)
from llavamod_tpu_torch.train import checkpoint as tckpt

TOL = 1e-5
KINDS = ["qformer2_32", "cheap_qformer2_32", "simple_in2_out2",
         "cheap_simple_in2_out2"]
VDIM, LDIM = 32, 48


def _noisy(tree, seed):
    """Seeded noise on every array leaf (the init leaves queries, biases
    and LayerNorms at 0 / 1); Python leaves stay."""
    rng = np.random.RandomState(seed)

    def add(x):
        if isinstance(x, (bool, int)):
            return x
        return x + jnp.asarray(0.05 * rng.randn(*x.shape).astype(np.float32))

    return jax.tree_util.tree_map(add, tree)


def _matched(kind, seed=0):
    jproj = jbuild_projector(kind, VDIM, LDIM)
    jparams = jax.device_get(_noisy(jproj.init(jax.random.PRNGKey(seed)),
                                    seed))
    proj = build_projector(kind, VDIM, LDIM)
    module = proj.init(torch.Generator().manual_seed(seed))
    load_jax_params(module, jparams)
    return jproj, jparams, proj, module


@pytest.mark.parametrize("kind", KINDS)
def test_projector_matches_jax(kind):
    jproj, jparams, proj, module = _matched(kind)
    # 144 tokens: a 12x12 grid (the simple projectors pool it to 6x6 and
    # their VALID conv takes it to 4x4)
    x = np.random.RandomState(1).randn(2, 144, VDIM).astype(np.float32)
    with torch.no_grad():
        got = proj.apply(module, torch.tensor(x)).numpy()
    want = np.asarray(jax.jit(lambda v: jproj.apply(jparams, v))(
        jnp.asarray(x)))
    assert got.shape == want.shape == (2, proj.num_output_tokens(144), LDIM)
    assert proj.num_output_tokens(576) == jproj.num_output_tokens(576)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_simple_projector_shapes_at_the_clip_grid():
    """576 CLIP tokens -> 144 after the pool -> 100 after the VALID conv;
    without out-blocks 144; the heads come from `_qf_heads`."""
    assert build_projector("simple_in1_out1", 1024, 2048
                           ).num_output_tokens(576) == 100
    assert build_projector("simple_in1_out0", 1024, 2048
                           ).num_output_tokens(576) == 144
    assert _qf_heads(2048) == 32 and _qf_heads(48) == 16 and _qf_heads(7) == 1
    proj = build_projector("simple_in1_out1", 16, 32)
    m = proj.init(torch.Generator().manual_seed(0))
    assert m.blocks_in[0].vit.heads == 32 and m.down2.same is False
    assert tuple(m.down2.kernel.shape) == (3, 3, 32, 32)


def test_qformer_matches_transformers_blip2():
    """The port's Q-Former == the reference's Blip2Model compute (proj_in
    -> Blip2QFormerModel [32 heads, cross-attention every layer, 2.6875x
    GELU MLP, post-LN, eps 1e-12] -> proj_out), weight for weight through
    the exported keys."""
    from transformers.models.blip_2.configuration_blip_2 import (
        Blip2QFormerConfig,
    )
    from transformers.models.blip_2.modeling_blip_2 import Blip2QFormerModel

    vision_dim, llm_dim, n_layers, n_queries = 80, 64, 2, 8
    spec = f"qformer{n_layers}_{n_queries}"
    proj = build_projector(spec, vision_dim, llm_dim)
    module = proj.init(torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    strip = {k[len("image_spatial_proj."):]: v for k, v in
             hf.projector_params_to_hf(module.state_dict(), spec,
                                       prefix="").items()}
    qf = Blip2QFormerModel(Blip2QFormerConfig(
        hidden_size=llm_dim, num_hidden_layers=n_layers,
        num_attention_heads=32, intermediate_size=int(llm_dim * 2.6875),
        encoder_hidden_size=llm_dim, cross_attention_frequency=1,
        hidden_act="gelu", layer_norm_eps=1e-12,
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)).eval()
    missing, unexpected = qf.load_state_dict(
        {k[len("qformer."):]: v for k, v in strip.items()
         if k.startswith("qformer.")}, strict=False)
    assert not unexpected, unexpected
    assert all("embedding" in k or "position" in k for k in missing), missing

    def seq(prefix, din, dmid, dout):
        m = torch.nn.Sequential(torch.nn.Linear(din, dmid), torch.nn.GELU(),
                                torch.nn.Linear(dmid, dout))
        for i in (0, 2):
            m[i].weight.data = strip[f"{prefix}.{i}.weight"]
            m[i].bias.data = strip[f"{prefix}.{i}.bias"]
        return m.eval()

    x = torch.tensor(np.random.default_rng(0).normal(
        size=(2, 10, vision_dim)).astype(np.float32))
    with torch.no_grad():
        img = seq("proj_in", vision_dim, llm_dim, llm_dim)(x)
        hidden = qf(query_embeds=strip["query_tokens"].expand(2, -1, -1),
                    encoder_hidden_states=img).last_hidden_state
        want = seq("proj_out", llm_dim, llm_dim, llm_dim)(hidden).numpy()
        got = proj.apply(module, x).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("src,dst", [(12, 24), (14, 42), (24, 10)])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(src).randn(2, 3, src, src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, dst, dst),
                                       method="bicubic"))
    got = resize_bicubic(torch.tensor(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if dst > src:
        # torch's bicubic (a = -0.75, clamped indices) is another function
        other = F.interpolate(torch.tensor(x), size=(dst, dst),
                              mode="bicubic", align_corners=False).numpy()
        assert np.abs(other - want).max() > 0.05


@pytest.mark.parametrize("scales", [(28, 56), (28, 56, 84)])
def test_multiscale_forward_matches_jax(scales):
    kw = dict(name="tiny-vit", image_size=28, patch_size=14, hidden_size=32,
              intermediate_size=64, num_layers=2, num_heads=4)
    jcfg, cfg = JVisionConfig(**kw), tvit.VisionConfig(**kw)
    jparams = jax.device_get(jvit.init(jcfg, jax.random.PRNGKey(0)))
    tower = tvit.init(cfg, torch.Generator())
    load_jax_params(tower, jparams)
    px = np.random.RandomState(2).randn(2, 3, 28, 28).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jmultiscale(jparams, jcfg, v,
                                                    scales))(jnp.asarray(px)))
    with torch.no_grad():
        got = multiscale_forward(tower, cfg, torch.tensor(px), scales).numpy()
    assert got.shape == (2, cfg.num_patches, 32 * len(scales))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", KINDS + ["pool_mlp2x_gelu"])
def test_mm_projector_bin_both_ways(tmp_path, kind):
    jproj, jparams, proj, module = _matched(kind, seed=4)
    port_file = tckpt.save_mm_projector(str(tmp_path / "port.bin"),
                                        module.state_dict(), kind)
    jax_file = jckpt.save_mm_projector(str(tmp_path / "jax.bin"), jparams,
                                       kind)
    a = torch.load(port_file, weights_only=True)
    b = torch.load(jax_file, weights_only=True)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    # JAX reads the port's file, the port reads JAX's
    template = jax.device_get(jproj.init(jax.random.PRNGKey(9)))
    back = jckpt.load_mm_projector(port_file, kind, template=template)
    jax.tree_util.tree_map(
        lambda u, v: np.testing.assert_array_equal(np.asarray(u),
                                                   np.asarray(v)),
        back, jparams)
    fresh = proj.init(torch.Generator().manual_seed(9))
    fresh.load_state_dict(tckpt.load_mm_projector(
        jax_file, kind, template=fresh.state_dict()), strict=True)
    for k, v in module.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.mark.parametrize("kind", ["qformer2_32", "cheap_qformer2_32"])
def test_qformer_hf_layout_both_ways(kind):
    _, jparams, _, module = _matched(kind, seed=5)
    state = hf.projector_params_to_hf(module.state_dict(), kind)
    want = jhf.projector_params_to_hf(jparams, kind)
    assert state.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np32(state[k]), want[k], err_msg=k)
    back = hf.projector_params_from_hf(state, kind)
    jback = jhf.projector_params_from_hf(
        {k: np.asarray(v) for k, v in want.items()}, kind)
    assert back.keys() == module.state_dict().keys()
    for k, v in module.state_dict().items():
        assert torch.equal(back[k], v), k
    jax.tree_util.tree_map(
        lambda u, v: np.testing.assert_array_equal(np.asarray(u),
                                                   np.asarray(v)),
        jback, jparams)
