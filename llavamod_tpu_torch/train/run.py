"""Training entry points for the three pipeline stages (port of
llavamod_tpu/train/run.py).

One engine for the paper's pipeline: build model(s) -> load an adapter /
upcycle to MoE -> data module -> step -> loop with metric logging, periodic
checkpoints and auto-resume -> final save.  The stages chain through
checkpoint directories:

    python -m llavamod_tpu_torch.train.run --stage pretrain \\
        --config configs/pretrain_qwen2_0_5b.json \\
        --model_name_or_path <dense dir> --data_path caps.json \\
        --image_folder imgs/ --output_dir out1/
    python -m llavamod_tpu_torch.train.run --stage align \\
        --config configs/dense2sparse_qwen2_0_5b.json \\
        --policy_model_name_or_path out1/ --ref_model_name_or_path <teacher> ...
    python -m llavamod_tpu_torch.train.run --stage dpo \\
        --config configs/preference_qwen2_0_5b.json \\
        --policy_model_name_or_path out2/ --ref_model_name_or_path <teacher> ...

(or the thin wrappers train.py / align_train.py / dpo_train.py).  Everything
runs on the card unless the caller passes `device="cpu"` to `run_stage` or
`main`.  Every branch of the JAX engine that the port does not run yet
raises NotImplementedError naming the ROADMAP Queue 1 item that ports it.

Per run the output directory gets `metrics.jsonl` (one line per
`logging_steps` microbatches), `run_info.json` (seconds spent building and
loading the models, in the loop and saving; microbatches and optimizer
updates), periodic `checkpoint-<step>/`, the final model
(`llavamod_config.json` + `model.pt`) and, for stage 1, `mm_projector.bin`.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import shutil
import signal
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch

from llavamod_tpu_torch.train.args import (
    AlignArgs,
    DataArgs,
    DPOArgs,
    ModelArgs,
    TrainArgs,
    parse_into_dataclasses,
    train_config_from_args,
)
from llavamod_tpu_torch.train.config import TrainConfig
from llavamod_tpu_torch.utils.logging import rank0_print

# reference module names (shells pass e.g. `--train_modules mlp.gate_proj
# wg`) -> the param-tree path fragments.  '/gate' etc. match both the dense
# '.../mlp/gate' and the expert '.../mlp/experts/gate' paths: in the
# reference the freeze runs before MoE expansion, so expert copies inherit
# the dense FFN's trainability.
_TRAIN_MODULE_ALIASES = {
    "mlp.gate_proj": "/gate",
    "mlp.up_proj": "/up",
    "mlp.down_proj": "/down",
    "gate_proj": "/gate",
    "up_proj": "/up",
    "down_proj": "/down",
    "wg": "router",
    "mlp.w1": "/gate",
    "mlp.w2": "/up",
    "mlp.c_proj": "/down",
    "fc1": "/up",
    "fc2": "/down",
}


def translate_train_modules(mods) -> Optional[Tuple[str, ...]]:
    if not mods:
        return None
    return tuple(_TRAIN_MODULE_ALIASES.get(m, m) for m in mods)


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, "
                               f"item {item})")


def refuse_unported(margs: ModelArgs, targs: TrainArgs) -> None:
    """Raise on every option of the JAX engine that the port does not run
    yet, before anything is built."""
    if margs.lora_enable:
        raise _not_ported("LoRA (--lora_enable)", 6)
    if margs.video_tower or margs.s2:
        raise _not_ported("video frames and S2 (--video_tower, --s2)", 6)
    if targs.fused_update:
        raise _not_ported("--fused_update", 4)
    if targs.optimizer != "adamw":
        raise _not_ported(f"--optimizer {targs.optimizer}", 4)
    if (max(targs.data_parallel, targs.expert_parallel, targs.tensor_parallel,
            targs.pipeline_parallel) > 1 or targs.sequence_parallel):
        raise _not_ported("data, expert, tensor, sequence and pipeline "
                          "parallelism", 9)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or (
            torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise _not_ported("multi-process training", 9)


# ---------------------------------------------------------------------------
# model construction
# ---------------------------------------------------------------------------

def build_llava(name_or_path: str, margs: ModelArgs, *, seed: int = 0,
                device="cuda"):
    """Resolve a model spec to (LlavaConfig, Llava) on `device`.

    A native checkpoint directory (llavamod_config.json + model.pt) loads
    in its stored dtype, with any missing group ('vision', 'projector',
    'llm') initialized fresh from `seed`; a registered preset name
    ('qwen1.5-0.5b', ...) is initialized from `seed` in float32."""
    from llavamod_tpu_torch.models import builder as model_builder
    from llavamod_tpu_torch.models import llava as llava_mod
    from llavamod_tpu_torch.models.llava import LlavaConfig
    from llavamod_tpu_torch.models.llm.config import llm_configs
    from llavamod_tpu_torch.models.vision.vit import vision_configs

    if os.path.isdir(name_or_path):
        if not os.path.exists(os.path.join(name_or_path,
                                           model_builder.CONFIG_NAME)):
            raise _not_ported(f"loading the HF checkpoint directory "
                              f"{name_or_path}", 7)
        cfg, model = model_builder.load_model(name_or_path, device=device,
                                              fill_missing_seed=seed)
        return cfg, model
    cfg = LlavaConfig(
        llm=llm_configs.get(name_or_path),
        vision=vision_configs.get(margs.image_tower),
        projector_type=margs.image_projector_type,
        select_layer=margs.mm_vision_select_layer,
        select_feature=margs.mm_vision_select_feature)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, llava_mod.init(cfg, gen, device=device, dtype=torch.float32)


def maybe_load_mm_adapter(model, path: Optional[str], projector_type: str):
    if path:
        from llavamod_tpu_torch.train.checkpoint import load_mm_projector

        state = load_mm_projector(path, projector_type,
                                  template=model.projector.state_dict())
        model.projector.load_state_dict(state, strict=True)
        rank0_print(f"[build] loaded mm projector from {path}")
    return model


def maybe_upcycle(cfg, model, margs: ModelArgs):
    """Dense -> sparse MoE student (initialize_moe_modules equivalent)."""
    if cfg.llm.is_moe:
        return cfg, model  # already sparse (moe_finetune/resume path)
    from llavamod_tpu_torch.models.llm.upcycle import upcycle

    with torch.no_grad():
        moe_cfg, model.llm = upcycle(
            cfg.llm, model.llm, moe_mode=margs.moe_mode,
            moe_layers_idx=margs.moe_layers_idx,
            num_experts=margs.num_experts, top_k=margs.top_k_experts,
            capacity_factor=margs.capacity_factor,
            eval_capacity_factor=margs.eval_capacity_factor,
            min_capacity=margs.min_capacity, use_residual=margs.use_residual,
            router_aux_loss_coef=margs.router_aux_loss_coef)
    cfg = cfg.replace(llm=moe_cfg)
    model.cfg = cfg
    rank0_print(f"[build] upcycled to MoE: layers={moe_cfg.moe_layers} "
                f"experts={moe_cfg.moe_num_experts}")
    return cfg, model


# ---------------------------------------------------------------------------
# data module
# ---------------------------------------------------------------------------

def build_data_module(stage: str, margs: ModelArgs, dargs: DataArgs,
                      targs: TrainArgs, tokenizer, cfg):
    from llavamod_tpu_torch.data.collator import DPOCollator, SupervisedCollator
    from llavamod_tpu_torch.data.dataset import (
        PreferenceJsonDataset,
        SupervisedJsonDataset,
    )
    from llavamod_tpu_torch.models.builder import make_image_preprocessor
    from llavamod_tpu_torch.train.loader import DataLoader
    from llavamod_tpu_torch.train.sampler import (
        LengthGroupedSampler,
        RandomSampler,
    )

    ds_cls = PreferenceJsonDataset if stage == "dpo" else SupervisedJsonDataset
    dataset = ds_cls(
        dargs.data_path, tokenizer, make_image_preprocessor(cfg),
        image_folder=dargs.image_folder, template_name=margs.version,
        model_max_length=targs.model_max_length,
        is_multimodal=dargs.is_multimodal, num_frames=dargs.num_frames,
        use_im_start_end=margs.mm_use_im_start_end, seed=targs.seed)
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    coll_cls = DPOCollator if stage == "dpo" else SupervisedCollator
    collator = coll_cls(max_len=targs.model_max_length,
                        num_image_tokens=cfg.num_image_tokens,
                        image_size=cfg.vision.image_size,
                        max_images=cfg.max_images, pad_id=pad_id)
    if targs.group_by_modality_length:
        sampler = LengthGroupedSampler(
            targs.per_device_train_batch_size,
            world_size=targs.gradient_accumulation_steps,
            lengths=dataset.modality_lengths,
            group_by_modality=True, seed=targs.seed)
    else:
        sampler = RandomSampler(len(dataset), seed=targs.seed)
    return DataLoader(dataset, targs.per_device_train_batch_size, collator,
                      sampler=sampler, drop_last=True,
                      num_workers=targs.dataloader_num_workers)


# ---------------------------------------------------------------------------
# metric logging
# ---------------------------------------------------------------------------

class MetricLogger:
    """Accumulate step metrics; emit means every logging_steps (reference
    store_metrics/log, align_trainer.py:596-614) to the console, to
    <output_dir>/metrics.jsonl, and to wandb when available."""

    def __init__(self, targs: TrainArgs, total_steps: int):
        self.every = max(1, targs.logging_steps)
        self.total = total_steps
        self.acc: Dict[str, float] = {}
        self.n = 0
        self.t0 = time.time()
        self.wandb = None
        self.jsonl = None
        try:
            os.makedirs(targs.output_dir, exist_ok=True)
            self.jsonl = open(os.path.join(targs.output_dir,
                                           "metrics.jsonl"), "a")
        except OSError as exc:
            rank0_print(f"[log] metrics.jsonl unavailable ({exc})")
        if targs.report_to == "wandb":
            try:
                import wandb  # type: ignore

                self.wandb = wandb
                wandb.init(project="llavamod_tpu_torch", name=targs.run_name,
                           config=dataclasses.asdict(targs))
            except Exception as exc:  # wandb absent/offline: log locally only
                rank0_print(f"[log] wandb unavailable ({exc}); console only")

    def update(self, step: int, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            self.acc[k] = self.acc.get(k, 0.0) + float(v)
        self.n += 1
        if step % self.every == 0:
            means = {k: v / self.n for k, v in self.acc.items()}
            dt = (time.time() - self.t0) / self.n
            parts = " ".join(f"{k}={v:.4g}" for k, v in sorted(means.items()))
            rank0_print(f"[step {step}/{self.total}] {parts} "
                        f"({dt:.2f}s/step)")
            if self.jsonl is not None:
                self.jsonl.write(json.dumps(
                    {"step": step, "sec_per_step": round(dt, 4), **means}) + "\n")
                self.jsonl.flush()
            if self.wandb is not None:
                self.wandb.log(means, step=step)
            self.acc, self.n, self.t0 = {}, 0, time.time()

    def close(self) -> None:
        if self.jsonl is not None:
            self.jsonl.close()


# ---------------------------------------------------------------------------
# checkpointing helpers
# ---------------------------------------------------------------------------

def _save_periodic(output_dir: str, step: int, state, tcfg: TrainConfig,
                   cfg, save_total_limit: Optional[int]):
    from llavamod_tpu_torch.train.checkpoint import (
        save_checkpoint,
        save_mm_projector,
    )

    path = save_checkpoint(output_dir, step, state)
    rank0_print(f"[ckpt] saved {path}")
    if tcfg.tune_mm_mlp_adapter or tcfg.stage == "pretrain":
        # stage-1 semantics: the artifact of record is mm_projector.bin
        save_mm_projector(os.path.join(path, "mm_projector.bin"),
                          state.model.projector.state_dict(),
                          cfg.projector_type)
    if save_total_limit:
        _prune_checkpoints(output_dir, save_total_limit)


def _prune_checkpoints(output_dir: str, keep: int):
    ckpts = []
    for name in os.listdir(output_dir):
        m = re.match(r"^checkpoint-(\d+)$", name)
        if m:
            ckpts.append((int(m.group(1)), os.path.join(output_dir, name)))
    for _, path in sorted(ckpts)[:-keep]:
        shutil.rmtree(path, ignore_errors=True)


# ---------------------------------------------------------------------------
# int8 W8A8 options
# ---------------------------------------------------------------------------

def quantize_stage_models(tcfg: TrainConfig, stage_args, model,
                          teacher) -> Dict[str, Any]:
    """Apply the stage's int8 options in place (JAX run.py:521-600):

      * `ref_quant` int8 / int8_head: the teacher's (stage 3: the
        reference's) LLM to W8A8, with its head for int8_head.  The layers
        are quantized one at a time on the device, each float layer
        dropped as its int8 form arrives;
      * student_head_quant (--policy_head_quant) with an explicit student
        head: the frozen head to int8 once; the float head is kept on the
        host for the checkpoint (a tied head is quantized per step
        instead, train/steps.py);
      * student_body_quant (--policy_body_quant): only routers may train
        among the decoder layers (checked on the actual trainable mask);
        the body, experts included, to int8; the float layers are kept on
        the host.

    Returns the host stash that `restore_float_weights` puts back."""
    from llavamod_tpu_torch.models.llm.decoder import (
        quantize_decoder_int8,
        quantize_head_int8,
    )
    from llavamod_tpu_torch.models.params import Int8Weight
    from llavamod_tpu_torch.train.optim import trainable_mask

    stash: Dict[str, Any] = {}
    rq = getattr(stage_args, "ref_quant", "") if stage_args else ""
    if rq not in ("", "int8", "int8_head"):
        raise ValueError(f"--ref_quant must be '', 'int8' or 'int8_head'; "
                         f"got {rq!r}")
    if teacher is not None and rq:
        quantize_decoder_int8(teacher.llm, include_lm_head=rq == "int8_head")
        rank0_print("[build] teacher attention/MLP quantized to int8 (W8A8)"
                    + (" + int8 LM head" if rq == "int8_head" else ""))
    llm = model.llm
    if (tcfg.student_head_quant and hasattr(llm, "lm_head")
            and not isinstance(llm.lm_head.weight, Int8Weight)):
        with torch.no_grad():
            stash["head"] = llm.lm_head.weight.detach().to("cpu", copy=True)
            head = quantize_head_int8(llm.lm_head.weight)
        del llm.lm_head._parameters["weight"]
        llm.lm_head.weight = head
        rank0_print("[build] student LM head pre-quantized to int8 "
                    "(frozen-head recipe; float head kept on the host)")
    if tcfg.student_body_quant:
        mask = trainable_mask(model, tcfg)
        bad = [n for n, t in mask.items()
               if t and n.startswith("llm.layers.") and "router" not in n]
        if bad:
            raise ValueError(
                "--policy_body_quant needs every decoder weight except the "
                f"router frozen via --train_modules; trainable: {bad[:4]}")
        stash["layers"] = [copy.deepcopy(layer).to("cpu")
                           for layer in llm.layers]
        quantize_decoder_int8(llm, include_experts=True)
        rank0_print("[build] student body quantized to int8 W8A8 (frozen "
                    "attn/MLP/experts; the straight-through backward "
                    "carries router gradients; float body kept on the host)")
    return stash


def restore_float_weights(model, stash: Dict[str, Any]) -> None:
    """Put the float head and body back for the export (the int8 copies
    were training-time stand-ins that never moved), grafting in the routers
    that did train."""
    from torch import nn

    llm = model.llm
    device = llm.final_norm.weight.device
    if "head" in stash:
        llm.lm_head.weight = nn.Parameter(stash["head"].to(device),
                                          requires_grad=False)
    for i, layer in enumerate(stash.get("layers", ())):
        layer = layer.to(device)
        if layer.is_moe:
            layer.mlp.router = llm.layers[i].mlp.router
        llm.layers[i] = layer


def final_save(output_dir: str, cfg, state, tcfg: TrainConfig):
    """The full model (llavamod_config.json + model.pt); stage 1 also
    exports mm_projector.bin (reference train.py:535-557)."""
    from llavamod_tpu_torch.models.builder import save_model
    from llavamod_tpu_torch.train.checkpoint import save_mm_projector

    save_model(output_dir, state.model)
    if tcfg.tune_mm_mlp_adapter or tcfg.stage == "pretrain":
        save_mm_projector(os.path.join(output_dir, "mm_projector.bin"),
                          state.model.projector.state_dict(),
                          cfg.projector_type)
    rank0_print(f"[ckpt] final model saved to {output_dir}")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def build_stage_models(stage: str, margs: ModelArgs, targs: TrainArgs,
                       salign: Optional[AlignArgs] = None,
                       sdpo: Optional[DPOArgs] = None, device="cuda"):
    """(cfg, model, teacher_cfg, teacher) for `stage`: the policy (with its
    adapter loaded and, where asked, upcycled to MoE) and, for align and
    dpo, the frozen teacher / reference model (None otherwise)."""
    policy_spec = margs.model_name_or_path
    teacher_cfg = teacher = None
    if stage == "align":
        policy_spec = salign.policy_model_name_or_path or policy_spec
        cfg, model = build_llava(policy_spec, margs, seed=targs.seed,
                                 device=device)
        maybe_load_mm_adapter(model, salign.policy_pretrain_mm_mlp_adapter
                              or margs.pretrain_mm_mlp_adapter,
                              cfg.projector_type)
        if salign.policy_model_type == "sparse" and margs.moe_enable:
            cfg, model = maybe_upcycle(cfg, model, margs)
        teacher_cfg, teacher = build_llava(
            salign.ref_model_name_or_path, margs, seed=targs.seed + 7,
            device=device)
        maybe_load_mm_adapter(teacher, salign.ref_pretrain_mm_mlp_adapter,
                              teacher_cfg.projector_type)
    elif stage == "dpo":
        policy_spec = sdpo.policy_model_name_or_path or policy_spec
        cfg, model = build_llava(policy_spec, margs, seed=targs.seed,
                                 device=device)
        teacher_cfg, teacher = build_llava(
            sdpo.ref_model_name_or_path, margs, seed=targs.seed + 7,
            device=device)
    else:
        cfg, model = build_llava(policy_spec, margs, seed=targs.seed,
                                 device=device)
        maybe_load_mm_adapter(model, margs.pretrain_mm_mlp_adapter,
                              cfg.projector_type)
        if margs.moe_enable and not targs.moe_finetune:
            cfg, model = maybe_upcycle(cfg, model, margs)
    if teacher is not None:
        teacher.requires_grad_(False)
    return cfg, model, teacher_cfg, teacher


def run_stage(stage: str, margs: ModelArgs, dargs: DataArgs, targs: TrainArgs,
              salign: Optional[AlignArgs] = None,
              sdpo: Optional[DPOArgs] = None,
              tokenizer=None, device="cuda") -> Dict[str, float]:
    """Run one full training stage on `device`; returns the last logged
    metrics."""
    from llavamod_tpu_torch.runtime.prefetch import DevicePrefetcher
    from llavamod_tpu_torch.train.checkpoint import maybe_auto_resume
    from llavamod_tpu_torch.train.loader import infinite_batches
    from llavamod_tpu_torch.train.optim import TrainState
    from llavamod_tpu_torch.train.steps import (
        _can_share_tower,
        batch_from_arrays,
        make_align_step,
        make_dpo_step,
        make_pretrain_step,
    )

    assert stage in ("pretrain", "finetune", "align", "dpo"), stage
    refuse_unported(margs, targs)
    t_build = time.perf_counter()
    if tokenizer is None:
        tokenizer = load_tokenizer(margs)
    cfg, model, teacher_cfg, teacher = build_stage_models(
        stage, margs, targs, salign, sdpo, device)

    # ---- data ----
    loader = build_data_module(stage, margs, dargs, targs, tokenizer, cfg)
    steps_per_epoch = max(1, len(loader))
    total_steps = (targs.max_steps if targs.max_steps > 0
                   else int(steps_per_epoch * targs.num_train_epochs))
    rank0_print(f"[run] stage={stage} steps/epoch={steps_per_epoch} "
                f"total_steps={total_steps}")

    train_modules = translate_train_modules(margs.train_modules)
    tcfg = train_config_from_args(
        stage, targs, total_steps,
        dataclasses.replace(margs, train_modules=train_modules), salign, sdpo)

    if teacher is not None and _can_share_tower(tcfg, cfg, teacher_cfg) \
            and hasattr(teacher, "vision"):
        # the frozen tower is shared with the teacher: drop its own copy
        del teacher.vision
    float_stash = quantize_stage_models(tcfg, salign or sdpo, model, teacher)

    # (prestack_layers has no effect: the JAX package pre-stacks the layer
    # trees for its lax.scan layer loop, a TPU workaround the port does not
    # carry)

    state = TrainState.create(model, tcfg)
    state, resumed = maybe_auto_resume(targs.output_dir, state)
    if resumed:
        rank0_print(f"[ckpt] auto-resumed from {resumed}")
    start_step = int(state.step)
    build_s = time.perf_counter() - t_build

    if stage == "align":
        step_fn = make_align_step(cfg, teacher_cfg, tcfg)
        call = lambda st, b: step_fn(  # noqa: E731
            st, teacher, batch_from_arrays(b, device=device))
    elif stage == "dpo":
        step_fn = make_dpo_step(cfg, teacher_cfg, tcfg)
        call = lambda st, b: step_fn(st, teacher, b)  # noqa: E731
    else:
        step_fn = make_pretrain_step(cfg, tcfg)
        call = lambda st, b: step_fn(  # noqa: E731
            st, batch_from_arrays(b, device=device))

    logger = MetricLogger(targs, total_steps)
    os.makedirs(targs.output_dir, exist_ok=True)
    last_metrics: Dict[str, float] = {}
    step_no = start_step

    # preemption safety: SIGTERM checkpoints at the next step boundary
    # before exiting (the reference relies on periodic saves only)
    stop_requested = []

    def _on_term(signum, frame):
        rank0_print("[run] SIGTERM received; checkpointing then exiting")
        stop_requested.append(True)

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # not the main thread
        prev_handler = None

    host_batches = infinite_batches(loader)
    profiler = None
    save_s = 0.0
    t_loop = time.perf_counter()
    try:
        for batch in DevicePrefetcher(host_batches, device=device):
            if step_no >= total_steps or stop_requested:
                break
            if targs.profile_steps and step_no == start_step + 1:
                profiler = _start_profiler(device)
            state, metrics = call(state, batch)
            step_no += 1
            last_metrics = {k: float(v) for k, v in metrics.items()}
            logger.update(step_no, last_metrics)
            if profiler is not None and \
                    step_no >= start_step + 1 + targs.profile_steps:
                _stop_profiler(profiler, targs.output_dir)
                profiler = None
            if stop_requested or (
                    targs.save_steps and step_no % targs.save_steps == 0
                    and step_no < total_steps):
                t_save = time.perf_counter()
                _save_periodic(targs.output_dir, step_no, state, tcfg, cfg,
                               targs.save_total_limit)
                save_s += time.perf_counter() - t_save
    finally:
        host_batches.close()
        logger.close()
        if profiler is not None:
            _stop_profiler(profiler, targs.output_dir)
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    loop_s = time.perf_counter() - t_loop - save_s

    t_save = time.perf_counter()
    restore_float_weights(state.model, float_stash)
    final_save(targs.output_dir, cfg, state, tcfg)
    save_s += time.perf_counter() - t_save
    info = {"stage": stage, "build_and_load_s": build_s, "loop_s": loop_s,
            "save_s": save_s, "microbatches": step_no - start_step,
            "step": step_no, "optimizer_updates": state.opt.updates,
            "resumed_from": resumed}
    with open(os.path.join(targs.output_dir, "run_info.json"), "w") as f:
        json.dump(info, f, indent=1)
    return last_metrics


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, output_dir: str) -> None:
    prof.__exit__(None, None, None)
    out = os.path.join(output_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    rank0_print(f"[run] wrote profile to {out}/trace.json")


def load_tokenizer(margs: ModelArgs):
    """An HF tokenizer from the model directory (transformers, imported
    here only)."""
    path = margs.model_name_or_path
    if os.path.isdir(path) and any(
            os.path.exists(os.path.join(path, f))
            for f in ("qwen.tiktoken", "arcade100k.tiktoken")):
        raise _not_ported("the tiktoken tokenizers (qwen-1.0, arcade100k)",
                          7)
    import transformers

    tok = transformers.AutoTokenizer.from_pretrained(path)
    if tok.pad_token is None and tok.unk_token is not None:
        tok.pad_token = tok.unk_token  # reference pad fixups train.py:365-385
    return tok


def main(argv=None, stage: Optional[str] = None, device="cuda") -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    # an explicit --stage always wins (e.g. `train.py --stage finetune`)
    if "--stage" in args:
        i = args.index("--stage")
        stage = args[i + 1]
        del args[i:i + 2]
    if stage is None:
        stage = "pretrain"
    classes = [ModelArgs, DataArgs, TrainArgs]
    if stage == "align":
        classes.append(AlignArgs)
        margs, dargs, targs, salign = parse_into_dataclasses(classes, args)
        run_stage(stage, margs, dargs, targs, salign=salign, device=device)
    elif stage == "dpo":
        classes.append(DPOArgs)
        margs, dargs, targs, sdpo = parse_into_dataclasses(classes, args)
        run_stage(stage, margs, dargs, targs, sdpo=sdpo, device=device)
    else:
        margs, dargs, targs = parse_into_dataclasses(classes, args)
        run_stage(stage, margs, dargs, targs, device=device)


if __name__ == "__main__":
    main()
