"""The port's LoRA (llavamod_tpu_torch/models/lora.py, the LoRA branches of
train/{optim,steps,run}.py, tools/merge_lora.py, `consolidate --base`,
`load_pretrained_model(..., model_base=...)`) against the JAX package's, on
the CPU at tiny widths, the JAX adapters carried over leaf for leaf:

  * `init_lora`: the JAX function's targets (FFN only, and with attention)
    on a dense + MoE model, a [.., in, r] / b [.., r, out] in the weight's
    dtype, b zero, a ~ N(0, 1) / r;
  * the merged weights against JAX's `merge_lora` (f32: 1e-6), the model
    unchanged outside the block;
  * 3 `make_align_step` steps with FFN adapters (the record train set
    otherwise: the router and the projector train, the adapted FFN
    weights freeze): every metric, the base and the adapters after the
    steps at the step test's 1.5e-3, the adapted weights bitwise unmoved;
  * PEFT adapter files both ways, expert adapters under DeepSpeed-MoE keys,
    bitwise; `peft.PeftModel.from_pretrained` on a tiny transformers Qwen2
    computes the port's merged model (logits 1e-4);
  * `tools.merge_lora` and `consolidate --base` against JAX's
    `merge_lora` tool at 1e-6 (f32; the rank-r products run in another
    order), non-targets bitwise the base;
  * `run_stage` with `--lora_enable` against JAX's (the JAX adapters' init
    handed to the port, as the two packages draw different numbers from
    one seed): the logged losses at 1e-4, `output_dir/adapter` and the
    merged model at the step test's 1.5e-3;
  * `load_pretrained_model(adapter, model_base=base)` gives the merged
    model, while the JAX loader reads the base from the adapter directory
    and fails there;
  * a LoRA run stopped at a checkpoint and auto-resumed ends with the
    adapters and merged model of an uninterrupted one."""

import json
import os

import numpy as np
import pytest
import torch
from util_torch_port import (
    flatten_numpy,
    matched_llava,
    tiny_llava_config,
    to_jax_llava,
)

import jax

from llavamod_tpu.models import builder as jbuilder
from llavamod_tpu.models import llava as jllava
from llavamod_tpu.models import lora as jlora
from llavamod_tpu.tools import merge_lora as jmerge_tool
from llavamod_tpu.train import args as jargs
from llavamod_tpu.train import run as jrun
from llavamod_tpu.train.config import TrainConfig as JTrainConfig
from llavamod_tpu.train.optim import TrainState as JTrainState
from llavamod_tpu.train.steps import (
    batch_from_arrays as jbatch_from_arrays,
    make_align_step as jmake_align_step,
)
from llavamod_tpu_torch.interop.from_jax import (
    load_jax_params,
    numpy_from_state_dict,
)
from llavamod_tpu_torch.models import builder
from llavamod_tpu_torch.models import llava as tllava
from llavamod_tpu_torch.models import lora as tlora
from llavamod_tpu_torch.models.llm import decoder as tdecoder
from llavamod_tpu_torch.tools import consolidate, merge_lora
from llavamod_tpu_torch.train import run as trun
from llavamod_tpu_torch.train.args import DataArgs, ModelArgs
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.train.optim import TrainState
from llavamod_tpu_torch.train.steps import batch_from_arrays, make_align_step

TOL = 1.5e-3     # the align step test's parity budget
VOCAB, CHUNK, T = 1000, 96, 24


def _jcfg(cfg: tlora.LoraConfig) -> jlora.LoraConfig:
    return jlora.LoraConfig(r=cfg.r, alpha=cfg.alpha, dropout=cfg.dropout,
                            target_patterns=cfg.target_patterns)


def _noisy(tree, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(
            np.float32), tree)


def matched_lora(jparams, model, cfg: tlora.LoraConfig, seed=1, noise=0.05):
    """JAX adapters (init_lora, then seeded noise so b is not zero) and the
    port's holding the same values."""
    jl = jax.device_get(jlora.init_lora(jparams, _jcfg(cfg),
                                        jax.random.PRNGKey(seed)))
    if noise:
        jl = _noisy(jl, seed, noise)
    lora = tlora.init_lora(model, cfg, torch.Generator().manual_seed(seed))
    load_jax_params(lora, jl)
    return jl, lora


def _targets(jl) -> set:
    return {k[:-2] for k in flatten_numpy(jl) if k.endswith(".a")}


@pytest.mark.parametrize("ffn_only", [True, False], ids=["ffn", "all"])
def test_init_lora_targets_and_shapes(ffn_only):
    cfg = tiny_llava_config()           # experts on layer 0, dense layer 1
    _, jparams, model = matched_llava(cfg)
    lcfg = tlora.LoraConfig(r=4, alpha=8, target_patterns=(
        tlora.FFN_TARGETS if ffn_only else tlora.DEFAULT_TARGETS))
    lora = tlora.init_lora(model.to(torch.bfloat16), lcfg,
                           torch.Generator().manual_seed(0))
    jl = jax.device_get(jlora.init_lora(jparams, _jcfg(lcfg),
                                        jax.random.PRNGKey(0)))
    assert set(lora.targets) == _targets(jl)
    want = {"llm.layers.0.mlp.experts.up", "llm.layers.1.mlp.down"}
    assert want <= set(lora.targets)
    assert any(".attn." in t for t in lora.targets) != ffn_only
    weights = dict(model.named_parameters())
    for t in lora.targets:
        pair, w = lora.pair(t), weights[t]
        assert pair.a.shape == (*w.shape[:-1], 4)
        assert pair.b.shape == (*w.shape[:-2], 4, w.shape[-1])
        assert pair.a.dtype == pair.b.dtype == torch.bfloat16
        assert not pair.b.any()
    a = lora.pair("llm.layers.0.mlp.experts.up").a.float()
    assert abs(a.std().item() * 4 - 1.0) < 0.2    # N(0, 1) / r
    assert set(lora.state_dict()) == {t + s for t in lora.targets
                                      for s in (".a", ".b")}


def test_merge_matches_jax_merge_lora():
    cfg = tiny_llava_config()
    _, jparams, model = matched_llava(cfg)
    lcfg = tlora.LoraConfig(r=4, alpha=16)
    jl, lora = matched_lora(jparams, model, lcfg)
    want = flatten_numpy(jax.device_get(
        jlora.merge_lora(jparams, jl, _jcfg(lcfg))))
    before = numpy_from_state_dict(model)
    with torch.no_grad(), tlora.lora_merged(model, lora, lcfg):
        inside = {k: v.detach().float().numpy().copy() for k, v in
                  model.named_parameters()}   # the merged weights
    after = numpy_from_state_dict(model)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    for k, w in want.items():
        np.testing.assert_allclose(inside[k], w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        assert (k in lora.targets) != np.array_equal(w, before[k]), k
    tlora.merge_lora_(model, lora, lcfg)
    merged = numpy_from_state_dict(model)
    for k in lora.targets:
        np.testing.assert_array_equal(merged[k], inside[k], err_msg=k)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    b, n_img, s = 2, cfg.num_image_tokens, cfg.vision.image_size
    ids = rng.randint(5, VOCAB, (b, T)).astype(np.int32)
    seg = np.ones((b, T), np.int32)
    seg[1, :5] = 0
    ids[1, :5] = 0
    im = np.zeros((b, T), bool)
    ip = np.zeros((b, T), np.int32)
    for i, st in enumerate((1, 6)):
        im[i, st:st + n_img] = True
        ip[i, st:st + n_img] = i * n_img + np.arange(n_img)
    labels = np.where(im | (seg == 0), -100, ids)
    labels[:, :T // 4] = -100
    return {"input_ids": ids, "segment_ids": seg, "image_mask": im,
            "image_pos": ip,
            "pixels": rng.randn(b, 1, 3, s, s).astype(np.float32),
            "pixel_valid": np.ones((b, 1), bool), "labels": labels}


def test_align_step_with_lora_matches_jax():
    student = tiny_llava_config(vocab_size=VOCAB)
    teacher = student.replace(llm=student.llm.replace(
        name="tiny-teacher", hidden_size=96, intermediate_size=160,
        num_heads=4, num_kv_heads=4, moe_num_experts=0, moe_layers=()))
    _, jparams, model = matched_llava(student, seed=0)
    jteacher = {k: v for k, v in jllava.init(
        to_jax_llava(teacher), jax.random.PRNGKey(7)).items() if k != "vision"}
    tmodel = tllava.init(teacher, torch.Generator().manual_seed(7),
                         vision=False)
    load_jax_params(tmodel, jax.device_get(jteacher))
    lcfg = tlora.LoraConfig(r=4, alpha=8, target_patterns=tlora.FFN_TARGETS)
    jl, lora = matched_lora(jparams, model, lcfg, noise=0.0)   # b = 0
    kw = dict(stage="align", align_loss_type="kd_lm", remat=True,
              compute_dtype="float32", vocab_chunk=CHUNK, learning_rate=5e-3,
              weight_decay=0.1, warmup_ratio=0.2, total_steps=10,
              max_grad_norm=1.0, train_modules=("/gate", "/up", "/down",
                                                "router"))
    jstate = JTrainState.create({"base": jparams, "lora": jl},
                                JTrainConfig(**kw), _jcfg(lcfg))
    jstep = jmake_align_step(to_jax_llava(student), to_jax_llava(teacher),
                             JTrainConfig(**kw), _jcfg(lcfg))
    state = TrainState.create(model, TrainConfig(**kw), lcfg, lora)
    step = make_align_step(student, teacher, TrainConfig(**kw), lcfg)
    arrays = _batch(student)
    jb = jbatch_from_arrays(arrays)
    tb = batch_from_arrays(arrays, device="cpu")
    before = numpy_from_state_dict(model)
    for i in range(3):
        jstate, jm = jstep(jstate, jteacher, jb)
        state, m = step(state, tmodel, tb)
        for name in ("loss", "loss/align", "loss/lm", "loss/moe_balance",
                     "num_tokens", "grad_norm"):
            np.testing.assert_allclose(m[name].item(), float(jm[name]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"step {i} {name}")
    params = jax.device_get(jstate.params)
    for got, want in ((numpy_from_state_dict(state.model),
                       flatten_numpy(params["base"])),
                      (numpy_from_state_dict(state.lora),
                       flatten_numpy(params["lora"]))):
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL,
                                       err_msg=k)
    after = numpy_from_state_dict(state.model)
    for t in lora.targets:             # PEFT freezes the wrapped weight
        np.testing.assert_array_equal(after[t], before[t], err_msg=t)
    assert not np.array_equal(after["llm.layers.0.mlp.router"],
                              before["llm.layers.0.mlp.router"])
    assert lora.pair("llm.layers.1.mlp.up").b.abs().sum() > 0
    assert all(p.grad is None for p in state.lora.parameters())


def test_peft_files_both_ways(tmp_path):
    cfg = tiny_llava_config()
    _, jparams, model = matched_llava(cfg)
    lcfg = tlora.LoraConfig(r=4, alpha=8)
    jl, lora = matched_lora(jparams, model, lcfg)
    port_dir = tlora.save_lora_adapter(str(tmp_path / "port"), lora, lcfg)
    jax_dir = jlora.save_lora_adapter(str(tmp_path / "jax"), jl, _jcfg(lcfg))
    a = torch.load(os.path.join(port_dir, "adapter_model.bin"),
                   weights_only=True)
    b = torch.load(os.path.join(jax_dir, "adapter_model.bin"),
                   weights_only=True)
    assert a.keys() == b.keys()
    assert any("deepspeed_experts.3.up_proj.lora_A" in k for k in a)
    for k in a:
        assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k
    for name in ("port", "jax"):
        with open(tmp_path / name / "adapter_config.json") as f:
            assert json.load(f)["lora_alpha"] == 8
    # the port reads JAX's files, JAX reads the port's
    got, got_cfg = tlora.load_lora_adapter(jax_dir, model)
    assert (got_cfg.r, got_cfg.alpha, got_cfg.scaling) == (4, 8, 2.0)
    assert set(got.targets) == set(lora.targets)
    for k, v in lora.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    back, _ = jlora.load_lora_adapter(port_dir, jparams)
    want = flatten_numpy(jl)
    for k, v in flatten_numpy(jax.device_get(back)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_peft_model_from_pretrained_computes_the_merged_model(tmp_path):
    peft = pytest.importorskip("peft")
    import transformers

    hf_cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf_model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    hf_dir = str(tmp_path / "qwen2")
    hf_model.save_pretrained(hf_dir)
    cfg, model = builder.import_hf_llava(hf_dir, device="cpu",
                                         fill_missing_seed=0)
    lcfg = tlora.LoraConfig(r=4, alpha=8)
    lora = tlora.init_lora(model, lcfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in lora.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    adapter = tlora.save_lora_adapter(str(tmp_path / "adapter"), lora, lcfg)
    wrapped = peft.PeftModel.from_pretrained(hf_model, adapter).eval()
    ids = torch.tensor(np.random.RandomState(0).randint(0, 128, (2, 12)))
    with torch.no_grad():
        want = wrapped(input_ids=ids).logits.numpy()
        tlora.merge_lora_(model, lora, lcfg)
        out = tdecoder.forward(model.llm, cfg.llm, input_ids=ids,
                               attn_impl="xla")
        got = tdecoder.logits_from_hidden(model.llm, cfg.llm,
                                          out.hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _saved_pair(tmp_path, seed=3):
    """A tiny dense LLaVA in both packages' native formats (the same
    weights) and an adapter directory for it, written by the port."""
    cfg = tiny_llava_config(moe_num_experts=0, moe_layers=())
    jcfg, jparams, model = matched_llava(cfg, seed=seed)
    jbase = jbuilder.save_model(str(tmp_path / "jbase"), jcfg, jparams)
    tbase = builder.save_model(str(tmp_path / "tbase"), model)
    lcfg = tlora.LoraConfig(r=4, alpha=8)
    _, lora = matched_lora(jparams, model, lcfg)
    adapter = tlora.save_lora_adapter(str(tmp_path / "adapter"), lora, lcfg)
    return jbase, tbase, adapter, model, lora, lcfg


def _weights(path):
    return {k: v.float().numpy() for k, v in torch.load(
        os.path.join(path, builder.WEIGHTS_NAME), weights_only=True).items()}


def test_merge_tool_and_consolidate_base_equal_jax_tool(tmp_path):
    jbase, tbase, adapter, model, lora, lcfg = _saved_pair(tmp_path)
    jout = jmerge_tool.merge_lora_weights(adapter, jbase,
                                          str(tmp_path / "jout"))
    want = flatten_numpy(jax.device_get(jbuilder.load_model(jout)[1]))
    outs = [merge_lora.main(["--model-path", adapter, "--model-base", tbase,
                             "--save-path", str(tmp_path / "tout"),
                             "--device", "cpu"]),
            consolidate.main(["--src", adapter, "--base", tbase, "--dst",
                              str(tmp_path / "cout"), "--device", "cpu"])]
    base = _weights(tbase)
    for out in outs:
        got = _weights(out)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
            assert (k in lora.targets) != np.array_equal(got[k], base[k]), k
    configs = []
    for d in (outs[0], tbase):
        with open(os.path.join(d, builder.CONFIG_NAME)) as f:
            configs.append(json.load(f))
    assert configs[0] == configs[1]


def test_load_pretrained_model_reads_the_base_from_model_base(tmp_path):
    jbase, tbase, adapter, model, lora, lcfg = _saved_pair(tmp_path)
    tok, merged, cfg, _, _ = builder.load_pretrained_model(
        adapter, model_base=tbase, device="cpu", tokenizer=object())
    tlora.merge_lora_(model, lora, lcfg)
    assert cfg == model.cfg
    for k, v in model.state_dict().items():
        assert torch.equal(merged.state_dict()[k], v), k
    # the JAX loader reads config and weights from the adapter directory
    # (llavamod_tpu/models/builder.py:176-185) and fails there
    with pytest.raises((OSError, ValueError)):
        jbuilder.load_pretrained_model(adapter, model_base=jbase)


def test_run_stage_with_lora_logs_the_losses_of_jax(tmp_path, monkeypatch):
    """`run_stage("pretrain")` with --lora_enable on the full LLM (no
    tune_mm_mlp_adapter): FFN adapters r 8 alpha 16, from one checkpoint
    and one dataset; the port is handed the JAX run's adapter init."""
    from test_torch_train_run import StubTok, _lines, _targs, _write_data

    cfg = tiny_llava_config(moe_num_experts=0, moe_layers=())
    jcfg, jparams, model = matched_llava(cfg, seed=0)
    jdir = jbuilder.save_model(str(tmp_path / "jbase"), jcfg, jparams)
    tdir = builder.save_model(str(tmp_path / "tbase"), model)
    sft, _, imgs = _write_data(tmp_path, n=4)
    margs = dict(version="plain", lora_enable=True, lora_r=8, lora_alpha=16)
    kw = dict(max_steps=3, gradient_accumulation_steps=1, learning_rate=1e-2)
    port_init = tlora.init_lora

    def jax_init(model_, lcfg, generator):
        jl = jax.device_get(jlora.init_lora(
            jbuilder.load_model(jdir)[1], _jcfg(lcfg),
            jax.random.PRNGKey(42 + 1)))            # TrainArgs.seed + 1
        lora = port_init(model_, lcfg, generator)
        load_jax_params(lora, jl)
        return lora

    monkeypatch.setattr(tlora, "init_lora", jax_init)
    data = dict(data_path=[sft], image_folder=imgs)
    trun.run_stage("pretrain", ModelArgs(model_name_or_path=tdir, **margs),
                   DataArgs(**data), _targs(tmp_path / "port", **kw),
                   tokenizer=StubTok(), device="cpu")
    jrun.run_stage("pretrain", jargs.ModelArgs(model_name_or_path=jdir,
                                               **margs),
                   jargs.DataArgs(**data),
                   jargs.TrainArgs(**vars(_targs(tmp_path / "jax", **kw))),
                   tokenizer=StubTok())
    got, want = _lines(tmp_path / "port"), _lines(tmp_path / "jax")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("loss", "loss/lm", "num_tokens", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    # the adapters in PEFT's layout, the merged model beside them
    out = str(tmp_path / "port")
    a = torch.load(os.path.join(out, "adapter", "adapter_model.bin"),
                   weights_only=True)
    b = torch.load(os.path.join(tmp_path / "jax", "adapter",
                                "adapter_model.bin"), weights_only=True)
    assert a.keys() == b.keys() and len(a) == 2 * 3 * cfg.llm.num_layers
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
    merged = _weights(out)
    jmerged = flatten_numpy(jax.device_get(jbuilder.load_model(
        str(tmp_path / "jax"))[1]))
    for k, w in jmerged.items():
        np.testing.assert_allclose(merged[k], w, rtol=TOL, atol=TOL,
                                   err_msg=k)
    remerged = merge_lora.main(["--model-path", os.path.join(out, "adapter"),
                                "--model-base", tdir, "--save-path",
                                str(tmp_path / "remerged"), "--device", "cpu"])
    again = _weights(remerged)
    for k in ("llm.layers.0.mlp.up", "llm.layers.1.mlp.down"):
        np.testing.assert_allclose(again[k], merged[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_lora_auto_resume_matches_an_uninterrupted_run(tmp_path):
    """A LoRA run stopped at its checkpoint after microbatch 1 (the
    adapters and their AdamW moments saved beside the model) and
    auto-resumed ends with the adapters and the merged model of an
    uninterrupted run."""
    from test_torch_train_run import StubTok, _info, _targs, _write_data

    cfg = tiny_llava_config(moe_num_experts=0, moe_layers=())
    _, _, model = matched_llava(cfg, seed=0)
    base = builder.save_model(str(tmp_path / "base"), model)
    sft, _, imgs = _write_data(tmp_path, n=4, same=True)
    kw = dict(max_steps=2, gradient_accumulation_steps=1, save_steps=1,
              save_total_limit=1, learning_rate=1e-2)

    def run(out):
        trun.run_stage(
            "pretrain", ModelArgs(model_name_or_path=base, version="plain",
                                  lora_enable=True, lora_r=4, lora_alpha=8),
            DataArgs(data_path=[sft], image_folder=imgs), _targs(out, **kw),
            tokenizer=StubTok(), device="cpu")

    whole, cut = tmp_path / "whole", tmp_path / "cut"
    run(whole)
    saved = torch.load(whole / "checkpoint-1" / "state.pt", weights_only=True)
    assert "llm.layers.0.mlp.up.b" in saved["lora"]
    assert "lora.llm.layers.0.mlp.up.b" in saved["opt"]["default"]["mu"]
    cut.mkdir()
    os.rename(whole / "checkpoint-1", cut / "checkpoint-1")
    run(cut)
    assert _info(cut)["resumed_from"] == str(cut / "checkpoint-1")
    for name in ("adapter/adapter_model.bin", builder.WEIGHTS_NAME):
        a = torch.load(whole / name, weights_only=True)
        b = torch.load(cut / name, weights_only=True)
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=1e-7,
                                       msg=k)
