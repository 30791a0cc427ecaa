"""Three faults of the JAX package that the port repairs, each shown in the
JAX package and held repaired in the port, on the CPU at tiny widths:

  * S2 with the video projector: the JAX package sizes the video projector
    at `vision_feature_dim` (hidden x len(s2_scales)) while `encode_video`
    runs the tower without S2, so its first video batch raises; the port
    sizes it at the tower's hidden size, runs the batch, and its video
    tokens equal JAX's `encode_video` without S2 on the same weights;
  * a LoRA run's `adapter/` holds no non_lora_trainables.bin in the JAX
    package, so a `--model-base` load loses the router and projector the
    run trained; the port writes the file (the router under DeepSpeed-MoE's
    `wg` name, the projector as in mm_projector.bin, PEFT's prefixes) and
    the `--model-base` load equals the merged directory bitwise after a run
    whose router moved by more than a bf16 ulp;
  * `--mm_use_im_start_end` wraps each image in `<im_start>` / `<im_end>`,
    which no JAX trainer adds to the tokenizer (`initialize_vision_tokenizer`
    has no caller there); the port's `initialize_vision_tokenizer` gives the
    JAX function's two new ids and vocab + 2 rows (untied head too, and
    the donor rows of an mm_projector.bin): the old rows and the donor rows
    bitwise, the mean rows within JAX's f32 summation bound (the port takes
    the mean in float64); `run_stage` calls it, so the tags tokenize to the
    two new ids."""

import os

import numpy as np
import pytest
import torch
from util_torch_port import matched_llava, tiny_llava_config, to_jax_llava

import jax
import jax.numpy as jnp

from llavamod_tpu.models import builder as jbuilder
from llavamod_tpu.models import llava as jllava
from llavamod_tpu.train import args as jargs
from llavamod_tpu.train import run as jrun
from llavamod_tpu_torch.constants import IMAGE_TOKEN_INDEX, VIDEO_TOKEN_INDEX
from llavamod_tpu_torch.data.collator import SupervisedCollator
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models.lora import NON_LORA_FILE
from llavamod_tpu_torch.train import run as trun
from llavamod_tpu_torch.train.args import DataArgs, ModelArgs

from test_torch_train_run import StubTok, _lines, _targs, _write_data


# ---------------------------------------------------------------------------
# S2 with the video projector
# ---------------------------------------------------------------------------

def _video_cfg(**kw):
    return tiny_llava_config(moe_num_experts=0, moe_layers=()).replace(
        video_projector_type="linear", video_global_proj=True,
        video_temporal_proj=True, video_spatial_proj=True,
        num_video_frames=2, **kw)


def _video_arrays(cfg, t=64, seed=0):
    """One row: text, an image, text, a video, text."""
    rng = np.random.RandomState(seed)
    s, f = cfg.vision.image_size, cfg.num_video_frames
    ids = list(rng.randint(5, cfg.llm.vocab_size, 3)) + [IMAGE_TOKEN_INDEX] \
        + list(rng.randint(5, 99, 2)) + [VIDEO_TOKEN_INDEX] + [7, 8]
    sample = dict(input_ids=ids, labels=ids,
                  pixels=rng.randn(1, 3, s, s).astype(np.float32),
                  video_pixels=rng.randn(f, 3, s, s).astype(np.float32))
    return SupervisedCollator(
        max_len=t, num_image_tokens=cfg.num_image_tokens, image_size=s,
        max_images=1, num_video_tokens=cfg.num_video_tokens,
        num_video_frames=f)([sample])


def test_s2_with_the_video_projector():
    plain = _video_cfg()
    s2 = _video_cfg(s2_scales=(28, 56))
    arrays = _video_arrays(s2)
    # JAX: the video projector is sized for S2 features it never gets
    js2 = to_jax_llava(s2)
    jparams_s2 = jllava.init(js2, jax.random.PRNGKey(3))
    assert jparams_s2["video_projector"]  # sized at vision_feature_dim
    jb = jllava.MultimodalBatch(**{k: jnp.asarray(v) for k, v in
                                   arrays.items() if k != "labels"})
    with pytest.raises(TypeError, match="dot_general"):
        jllava.forward(jparams_s2, js2, jb, attn_impl="xla")

    # the port: the projector takes the tower's width, and the batch runs
    jcfg, jparams, model_plain = matched_llava(plain, seed=3)
    model = tllava.init(s2, torch.Generator().manual_seed(3))
    own = model.state_dict()
    shared = {k: v for k, v in model_plain.state_dict().items()
              if not k.startswith("projector.")}
    assert all(own[k].shape == v.shape for k, v in shared.items())
    model.load_state_dict(shared, strict=False)
    tb = tllava.MultimodalBatch(**{k: torch.as_tensor(v) for k, v in
                                   arrays.items() if k != "labels"})
    with torch.no_grad():
        hidden = tllava.forward(model, s2, tb, attn_impl="xla").hidden
        got = tllava.encode_video(model, s2, tb.video_pixels, tb.video_valid)
    assert torch.isfinite(hidden).all()
    want = jllava.encode_video(jparams, jcfg, jb.video_pixels, jb.video_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert s2.vision_feature_dim == 2 * s2.vision.hidden_size


# ---------------------------------------------------------------------------
# non_lora_trainables.bin
# ---------------------------------------------------------------------------

def test_a_lora_run_carries_the_router_in_non_lora_trainables(tmp_path):
    cfg = tiny_llava_config(moe_num_experts=4, moe_layers=(0,))
    jcfg, jparams, model = matched_llava(cfg, seed=0)
    tdir = builder.save_model(str(tmp_path / "tbase"), model)
    jdir = jbuilder.save_model(str(tmp_path / "jbase"), jcfg, jparams)
    sft, _, imgs = _write_data(tmp_path, n=4)
    margs = dict(version="plain", lora_enable=True, lora_r=4, lora_alpha=8,
                 train_modules=["wg"])
    kw = dict(max_steps=2, gradient_accumulation_steps=1, learning_rate=1e-2)
    data = DataArgs(data_path=[sft], image_folder=imgs)
    out = str(tmp_path / "port")
    trun.run_stage("pretrain", ModelArgs(model_name_or_path=tdir, **margs),
                   data, _targs(out, **kw), tokenizer=StubTok(), device="cpu")
    assert len(_lines(out)) == 2

    # the file: the router (HF [E, D]) and the projector, nothing adapted
    saved = torch.load(os.path.join(out, "adapter", NON_LORA_FILE),
                       weights_only=True)
    wg = "base_model.model.model.layers.0.mlp.deepspeed_moe.gate.wg.weight"
    assert wg in saved and saved[wg].shape == (4, cfg.llm.hidden_size)
    proj = [k for k in saved if "mm_projector" in k]
    assert proj and all(k.startswith("base_model.model.model.mm_projector.")
                        for k in proj)
    assert set(saved) == {wg, *proj}
    merged = torch.load(os.path.join(out, "model.pt"), weights_only=True)
    base = model.state_dict()
    router = "llm.layers.0.mlp.router"
    assert torch.equal(saved[wg].t(), merged[router])
    # the router moved, by more than a bf16 ulp
    assert not torch.equal(merged[router].bfloat16(), base[router].bfloat16())

    # the --model-base load equals the merged directory, every tensor
    _, loaded, lcfg, _, _ = builder.load_pretrained_model(
        os.path.join(out, "adapter"), model_base=tdir, device="cpu",
        tokenizer=object())
    assert lcfg == builder.load_model(out, device="cpu")[0]
    got = loaded.state_dict()
    assert got.keys() == merged.keys()
    for k, v in merged.items():
        assert torch.equal(got[k], v), k
    moved = [k for k in merged if not torch.equal(merged[k], base[k])]
    assert router in moved and "projector.layers.0.kernel" in moved

    # JAX: the same run's adapter directory has no such file
    jout = str(tmp_path / "jax")
    jrun.run_stage("pretrain", jargs.ModelArgs(model_name_or_path=jdir,
                                               **margs),
                   jargs.DataArgs(data_path=[sft], image_folder=imgs),
                   jargs.TrainArgs(**vars(_targs(jout, **kw))),
                   tokenizer=StubTok())
    assert os.path.exists(os.path.join(jout, "adapter", "adapter_model.bin"))
    assert not os.path.exists(os.path.join(jout, "adapter", NON_LORA_FILE))


# ---------------------------------------------------------------------------
# initialize_vision_tokenizer
# ---------------------------------------------------------------------------

class AddTok(StubTok):
    """StubTok with `add_tokens`: an added token is one id, numbered from
    the vocabulary size on, and the text around it is split off first."""

    def __init__(self, vocab):
        self.vocab = vocab
        self.added = {}

    def add_tokens(self, tokens, special_tokens=False):
        new = [t for t in tokens if t not in self.added]
        for t in new:
            self.added[t] = self.vocab + len(self.added)
        return len(new)

    def __call__(self, text):
        ids = []
        while text:
            hits = [(text.find(t), t) for t in self.added if t in text]
            if not hits:
                ids += super().__call__(text).input_ids
                break
            at, tok = min(hits)
            ids += super().__call__(text[:at]).input_ids + [self.added[tok]]
            text = text[at + len(tok):]
        return type("R", (), {"input_ids": ids})()


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("patch", [False, True], ids=["start_end", "patch"])
def test_initialize_vision_tokenizer_matches_jax(tied, patch):
    cfg = tiny_llava_config(moe_num_experts=0, moe_layers=(),
                            tie_word_embeddings=tied)
    jcfg, jparams, model = matched_llava(cfg, seed=1)
    vocab = cfg.llm.vocab_size
    jtok, ttok = AddTok(vocab), AddTok(vocab)
    kw = dict(mm_use_im_patch_token=patch, mm_use_im_start_end=True)
    jparams, jcfg2 = jllava.initialize_vision_tokenizer(jparams, jcfg, jtok,
                                                        **kw)
    cfg2, model2 = tllava.initialize_vision_tokenizer(model, cfg, ttok, **kw)
    n = 3 if patch else 2
    assert model2 is model and model.cfg == cfg2
    assert cfg2.llm.vocab_size == jcfg2.llm.vocab_size == vocab + n
    assert ttok.added == jtok.added
    assert sorted(ttok.added.values()) == list(range(vocab, vocab + n))
    emb = model.llm.embed.embedding
    assert emb.shape == (vocab + n, cfg.llm.hidden_size) and emb.requires_grad
    assert hasattr(model.llm, "lm_head") != tied
    pairs = [(emb, jparams["llm"]["embed"]["embedding"])]
    if not tied:
        pairs.append((model.llm.lm_head.weight,
                      jparams["llm"]["lm_head"]["weight"]))
    for got, want in pairs:
        got, want = got.detach().numpy(), np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:vocab], want[:vocab])
        # the new rows: the mean of the old ones, which the port takes in
        # float64 and JAX in f32 in XLA's reduction order; held to the f32
        # summation bound of the JAX side, vocab * eps * mean |w|
        bound = vocab * np.finfo(np.float32).eps * np.abs(want[:vocab]).mean(0)
        assert (np.abs(got[vocab:] - want[vocab:]) <= bound).all()
        np.testing.assert_array_equal(
            got[vocab:], np.broadcast_to(
                want[:vocab].astype(np.float64).mean(0).astype(np.float32),
                got[vocab:].shape))
    # the same tokens again add nothing
    assert tllava.initialize_vision_tokenizer(model, cfg2, ttok, **kw)[0] \
        == cfg2


def test_initialize_vision_tokenizer_takes_the_donor_rows(tmp_path):
    cfg = tiny_llava_config(moe_num_experts=0, moe_layers=())
    d = cfg.llm.hidden_size
    rng = np.random.RandomState(4)
    for shape in ((2, d), (cfg.llm.vocab_size + 2, d)):
        path = str(tmp_path / f"mm_projector_{shape[0]}.bin")
        torch.save({"model.embed_tokens.weight": torch.tensor(
            rng.randn(*shape).astype(np.float32))}, path)
        jcfg, jparams, model = matched_llava(cfg, seed=1)
        kw = dict(mm_use_im_start_end=True, pretrain_mm_mlp_adapter=path)
        jparams, _ = jllava.initialize_vision_tokenizer(
            jparams, jcfg, AddTok(cfg.llm.vocab_size), **kw)
        tllava.initialize_vision_tokenizer(model, cfg,
                                           AddTok(cfg.llm.vocab_size), **kw)
        want = np.asarray(jparams["llm"]["embed"]["embedding"])
        got = model.llm.embed.embedding.detach().numpy()
        np.testing.assert_array_equal(got, want)
        donor = torch.load(path, weights_only=True)["model.embed_tokens.weight"]
        np.testing.assert_array_equal(got[-2:], donor[-2:].numpy())
    torch.save({"model.embed_tokens.weight": torch.zeros(5, d)},
               str(tmp_path / "bad.bin"))
    _, _, model = matched_llava(cfg, seed=1)
    with pytest.raises(ValueError, match="Unexpected embed_tokens_weight"):
        tllava.initialize_vision_tokenizer(
            model, cfg, AddTok(cfg.llm.vocab_size), mm_use_im_start_end=True,
            pretrain_mm_mlp_adapter=str(tmp_path / "bad.bin"))


def test_run_stage_with_mm_use_im_start_end_adds_the_tokens(tmp_path):
    from llavamod_tpu_torch.constants import (
        DEFAULT_IM_END_TOKEN,
        DEFAULT_IM_START_TOKEN,
    )

    cfg = tiny_llava_config(moe_num_experts=0, moe_layers=())
    jcfg, jparams, model = matched_llava(cfg, seed=0)
    tdir = builder.save_model(str(tmp_path / "tbase"), model)
    jdir = jbuilder.save_model(str(tmp_path / "jbase"), jcfg, jparams)
    sft, _, imgs = _write_data(tmp_path, n=4)
    # (the plain template keeps only the `<image>` of its first turn)
    margs = dict(version="qwen", tune_mm_mlp_adapter=True,
                 mm_use_im_start_end=True)
    kw = dict(max_steps=2, gradient_accumulation_steps=1)
    vocab = cfg.llm.vocab_size
    tok = AddTok(vocab)
    out = str(tmp_path / "port")
    margs_t = ModelArgs(model_name_or_path=tdir, **margs)
    dargs = DataArgs(data_path=[sft], image_folder=imgs)
    targs = _targs(out, **kw)
    trun.run_stage("pretrain", margs_t, dargs, targs, tokenizer=tok,
                   device="cpu")
    start, end = vocab, vocab + 1
    assert tok.added == {DEFAULT_IM_START_TOKEN: start,
                         DEFAULT_IM_END_TOKEN: end}
    lines = _lines(out)
    assert len(lines) == 2 and all(np.isfinite(ln["loss"]) for ln in lines)
    ocfg, omodel = builder.load_model(out, device="cpu")
    emb = omodel.llm.embed.embedding.detach()
    assert ocfg.llm.vocab_size == vocab + 2 and emb.shape[0] == vocab + 2
    # the new rows: the mean of the old ones (stage 1 trains the projector)
    old = model.llm.embed.embedding.detach()
    assert torch.equal(emb[:vocab], old)
    assert torch.equal(emb[vocab:], old.double().mean(0, keepdim=True)
                       .float().expand(2, -1))
    # the tags tokenize to the two new ids, around the image
    loader = trun.build_data_module("pretrain", margs_t, dargs, targs, tok,
                                    ocfg)
    ids = list(loader.dataset[0]["input_ids"])
    at = ids.index(IMAGE_TOKEN_INDEX)
    assert ids[at - 1:at + 2] == [start, IMAGE_TOKEN_INDEX, end]

    # JAX: its trainer never adds them, so the same run tokenizes the tags
    # into character pieces
    jtok = AddTok(vocab)
    jrun.run_stage("pretrain", jargs.ModelArgs(model_name_or_path=jdir,
                                               **margs),
                   jargs.DataArgs(data_path=[sft], image_folder=imgs),
                   jargs.TrainArgs(**vars(_targs(tmp_path / "jax", **kw))),
                   tokenizer=jtok)
    assert jtok.added == {}
    assert jbuilder.load_model(str(tmp_path / "jax"))[0].llm.vocab_size \
        == vocab
