"""The port's video path (llavamod_tpu_torch/models/video.py, `encode_video`
and the [image rows | video rows] media table of models/llava.py, the
trainer's video data) against the JAX package's, on the CPU at tiny widths,
the JAX weights carried over leaf for leaf, f32:

  * the video projector for each combination of the global / temporal /
    spatial summaries (linear patch projector), and with the simple
    projector on the patches: outputs at 1e-5, token counts equal;
  * `llava.forward` on a batch whose first row holds an image and a video
    and whose second holds a video only (spliced by the port's collator):
    hidden states at 1e-4;
  * `run_stage("pretrain")` on video records (frame PNGs, `<video>` in the
    text) from one checkpoint with the video projector: the logged losses
    at 1e-4, and only projector.* and video_projector.* moved."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from util_torch_port import (
    matched_llava,
    np32,
    tiny_llava_config,
)

import jax
import jax.numpy as jnp

from llavamod_tpu.models import builder as jbuilder
from llavamod_tpu.models import llava as jllava
from llavamod_tpu.models.video import (
    VideoProjectorConfig as JVideoProjectorConfig,
    build_video_projector as jbuild_video_projector,
)
from llavamod_tpu.train import args as jargs
from llavamod_tpu.train import run as jrun
from llavamod_tpu_torch.constants import IMAGE_TOKEN_INDEX, VIDEO_TOKEN_INDEX
from llavamod_tpu_torch.data.collator import SupervisedCollator
from llavamod_tpu_torch.interop.from_jax import load_jax_params
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models.video import (
    VideoProjectorConfig,
    build_video_projector,
)
from llavamod_tpu_torch.train import run as trun
from llavamod_tpu_torch.train.args import DataArgs, ModelArgs


def _video_cfg(**kw):
    flags = dict(video_projector_type="linear", video_global_proj=True,
                 video_temporal_proj=True, video_spatial_proj=True,
                 num_video_frames=2)
    flags.update(kw)
    return tiny_llava_config(moe_num_experts=0, moe_layers=()).replace(
        **flags)


@pytest.mark.parametrize("spec,flags", [
    ("linear", (False, False, False)), ("linear", (True, False, False)),
    ("linear", (False, True, False)), ("linear", (False, False, True)),
    ("linear", (True, True, True)), ("simple_in1_out1", (True, True, True)),
], ids=["none", "global", "temporal", "spatial", "all", "simple-all"])
def test_video_projector_matches_jax(spec, flags):
    g, tp, sp = flags
    kw = dict(projector_type=spec, global_proj=g, temporal_proj=tp,
              spatial_proj=sp)
    vdim, ldim, n = 12, 16, (144 if spec.startswith("simple") else 9)
    jvp = jbuild_video_projector(JVideoProjectorConfig(**kw), vdim, ldim)
    rng = np.random.RandomState(0)
    jparams = jax.device_get(jax.tree_util.tree_map(
        lambda x: x if isinstance(x, (bool, int)) else x + jnp.asarray(
            0.05 * rng.randn(*x.shape).astype(np.float32)),
        jvp.init(jax.random.PRNGKey(0))))
    vp = build_video_projector(VideoProjectorConfig(**kw), vdim, ldim)
    module = vp.init(torch.Generator().manual_seed(0))
    load_jax_params(module, jparams)
    feats = rng.randn(2, 3, 1 + n, vdim).astype(np.float32)
    want = np.asarray(jax.jit(lambda f: jvp.apply(jparams, f))(
        jnp.asarray(feats)))
    with torch.no_grad():
        got = vp.apply(module, torch.tensor(feats)).numpy()
    assert got.shape == want.shape
    assert got.shape[1] == vp.num_output_tokens(3, n) == \
        jvp.num_output_tokens(3, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _video_batch(cfg, t=48, seed=0):
    """Row 0: text, an image, text, a video, text; row 1: text, a video,
    text (its image row stays invalid)."""
    rng = np.random.RandomState(seed)
    s, f = cfg.vision.image_size, cfg.num_video_frames

    def ids(n):
        return list(rng.randint(5, cfg.llm.vocab_size, n))

    rows = [ids(3) + [IMAGE_TOKEN_INDEX] + ids(4) + [VIDEO_TOKEN_INDEX]
            + ids(5), ids(2) + [VIDEO_TOKEN_INDEX] + ids(6)]
    samples = [dict(input_ids=r, labels=r,
                    video_pixels=rng.randn(f, 3, s, s).astype(np.float32))
               for r in rows]
    samples[0]["pixels"] = rng.randn(1, 3, s, s).astype(np.float32)
    return SupervisedCollator(
        max_len=t, num_image_tokens=cfg.num_image_tokens, image_size=s,
        max_images=1, num_video_tokens=cfg.num_video_tokens,
        num_video_frames=f)(samples)


def test_llava_forward_with_video_matches_jax():
    cfg = _video_cfg()
    jcfg, jparams, model = matched_llava(cfg, seed=2)
    assert cfg.num_video_tokens == jcfg.num_video_tokens == 2 * (4 + 2) + 4
    arrays = _video_batch(cfg)
    assert arrays["image_mask"].sum() == cfg.num_image_tokens \
        + 2 * cfg.num_video_tokens
    jb = jllava.MultimodalBatch(**{k: jnp.asarray(v) for k, v in
                                   arrays.items() if k != "labels"})
    want = np.asarray(jllava.forward(jparams, jcfg, jb,
                                     attn_impl="xla").hidden)
    tb = tllava.MultimodalBatch(**{k: torch.as_tensor(v) for k, v in
                                   arrays.items() if k != "labels"})
    with torch.no_grad():
        got = tllava.forward(model, cfg, tb, attn_impl="xla").hidden
    np.testing.assert_allclose(np32(got), want, rtol=1e-4, atol=1e-4)
    # the video rows reach the decoder: a video-only change moves row 1
    tb2 = tb._replace(video_pixels=tb.video_pixels * 2)
    with torch.no_grad():
        moved = tllava.forward(model, cfg, tb2, attn_impl="xla").hidden
    assert not torch.allclose(moved[1], got[1])


def _write_video_data(root, n=4):
    frames = root / "frames"
    frames.mkdir()
    records = []
    for i in range(n):
        names = []
        for j in range(3):         # 3 frames, subsampled to 2
            name = f"v{i}_{j}.png"
            Image.new("RGB", (32, 32), ((i * 40 + j * 9) % 255, 60, 90)
                      ).save(frames / name)
            names.append(name)
        records.append({"id": i, "video": names, "conversations": [
            {"from": "human", "value": "<video>\nwhat happens?"},
            {"from": "gpt", "value": f"a clip of a bus {i}"}]})
    (root / "video.json").write_text(json.dumps(records))
    return str(root / "video.json"), str(frames)


def test_run_stage_on_video_records_logs_the_losses_of_jax(tmp_path):
    from test_torch_train_run import StubTok, _lines, _targs

    cfg = _video_cfg()
    jcfg, jparams, model = matched_llava(cfg, seed=0)
    jdir = jbuilder.save_model(str(tmp_path / "jbase"), jcfg, jparams)
    tdir = builder.save_model(str(tmp_path / "tbase"), model)
    data, frames = _write_video_data(tmp_path)
    # the plain template keeps only an <image> in the first turn: video
    # records take a conversation template
    margs = dict(version="qwen", tune_mm_mlp_adapter=True)
    kw = dict(max_steps=2, gradient_accumulation_steps=1,
              per_device_train_batch_size=2, model_max_length=320)
    dkw = dict(data_path=[data], image_folder=frames)
    trun.run_stage("pretrain", ModelArgs(model_name_or_path=tdir, **margs),
                   DataArgs(**dkw), _targs(tmp_path / "port", **kw),
                   tokenizer=StubTok(), device="cpu")
    jrun.run_stage("pretrain", jargs.ModelArgs(model_name_or_path=jdir,
                                               **margs),
                   jargs.DataArgs(**dkw),
                   jargs.TrainArgs(**vars(_targs(tmp_path / "jax", **kw))),
                   tokenizer=StubTok())
    got, want = _lines(tmp_path / "port"), _lines(tmp_path / "jax")
    assert len(got) == len(want) == 2 and got[0]["num_tokens"] > 10
    for g, w in zip(got, want):
        for k in ("loss", "loss/lm", "num_tokens", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    before = torch.load(os.path.join(tdir, builder.WEIGHTS_NAME),
                        weights_only=True)
    after = torch.load(os.path.join(tmp_path, "port", builder.WEIGHTS_NAME),
                       weights_only=True)
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert any(k.startswith("video_projector.") for k in moved)
    assert all(k.split(".")[0] in ("projector", "video_projector")
               for k in moved)
