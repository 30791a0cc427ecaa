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
`main`.  `--optimizer adafactor` runs on every stage; `--fused_update`
(align stage, Adafactor) takes the fused backward+update step
(train/fused_steps.py), with the loader folding each `accum` microbatches
into one batch.  `--lora_enable` trains LoRA adapters (models/lora.py) on
the targets' frozen weights, merged on the fly each step; `--s2` and
`--video_tower` build a preset model with the S2 tower or the video
projector (a checkpoint directory keeps the configuration it was saved
with, as in the JAX engine).

Under `torchrun` (one process per card) every stage trains data parallel
with FSDP2 (ZeRO-3) and, with `--expert_parallel`, expert parallelism, and
with `--tensor_parallel` tensor parallelism (`--sequence_parallel true`:
the residual stream T-sharded between the blocks):

    torchrun --nproc_per_node 8 -m llavamod_tpu_torch.train.run \\
        --stage align --config configs/dense2sparse_qwen2_0_5b.json \\
        --expert_parallel 2 --tensor_parallel 2 --sequence_parallel true ...

and with `--pipeline_parallel N` pipeline parallelism (a GPipe schedule of
`--pipeline_microbatches M` microbatches, M = N when 0, over N stages that
each keep a contiguous block of the decoder's layers, parallel/pipeline.py;
`--fused_update` cannot run under it, as in the JAX engine):

    torchrun --nproc_per_node 4 -m llavamod_tpu_torch.train.run \
        --stage align --config configs/dense2sparse_qwen2_0_5b.json \
        --pipeline_parallel 2 --pipeline_microbatches 4 ...

`init_distributed` joins the process group (NCCL on cuda:$LOCAL_RANK; gloo
when the caller asked for the CPU; a group the caller started is taken as
it is), `_DeviceContext` builds the mesh (pipe x data x fsdp x expert x
tensor = the world, every remaining rank on fsdp) whenever a process group
is up, each rank's loader reads the `ProcessShardSampler` shard of its row
rank (the ranks of a tensor group and of a pipe group read the same rows),
both models are sharded
(parallel/sharding.py), a step on the rows of data x fsdp x expert is the
single-process step on them (train/steps.py), periodic checkpoints are
sharded (train/checkpoint.py) and rank 0 writes the final model in the
single-process format, the metrics and run_info.json.  `--fused_update`
drives each unit's gather and gradient reduction itself
(train/fused_steps.py); `--lora_enable` keeps the adapters beside the
sharded model, split as their bases are (parallel/sharding.py
`shard_lora`), and rank 0 writes `adapter/` and the merged model.  Every
branch of the JAX engine runs.

Per run the output directory gets `metrics.jsonl` (one line per
`logging_steps` steps: microbatches, or fused updates), `run_info.json`
(seconds spent building and loading the models, in the loop and saving;
microbatches and optimizer updates), periodic `checkpoint-<step>/` (<step>
counts loop steps; a resumed run skips the batches of the steps before
it), the final model (`llavamod_config.json` + `model.pt`)
and, for stage 1, `mm_projector.bin`; with LoRA the final model is the
merged one and `adapter/` holds the adapters in PEFT's layout.
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


def _launched() -> Tuple[bool, int]:
    """(a process group is up or torchrun launched this process, its
    world size)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return True, dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        return True, int(os.environ["WORLD_SIZE"])
    return False, 1


def refuse_unported(margs: ModelArgs, targs: TrainArgs) -> None:
    """Raise, before anything is built, on a combination of options the JAX
    engine refuses too (the fused step under the pipeline) and on a mesh
    the processes cannot fill."""
    if targs.fused_update and targs.pipeline_parallel > 1:
        raise ValueError("--fused_update drives its own reverse layer scan "
                         "and cannot run under --pipeline_parallel; drop one "
                         "of the two")
    _, world = _launched()
    need = _mesh_need(targs)
    if world % need:
        raise ValueError(
            f"--data_parallel x --expert_parallel x --tensor_parallel x "
            f"--pipeline_parallel = {need} does not divide the {world} "
            "processes: launch one process per card with torchrun "
            "--nproc_per_node")


def _mesh_need(targs: TrainArgs) -> int:
    """The ranks the parallel flags name (fsdp takes the rest)."""
    return (targs.data_parallel * targs.expert_parallel
            * targs.tensor_parallel * targs.pipeline_parallel)


def init_distributed(device="cuda"):
    """Join the process group that torchrun's environment describes
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on
    cuda:$LOCAL_RANK, gloo only when the caller asked for the CPU.  A
    failed NCCL start raises; nothing falls back.  Returns (the rank's
    device, whether this call started the group)."""
    dist = torch.distributed
    dev = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev, False
    if "WORLD_SIZE" not in os.environ:
        return dev, False
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
    else:
        dist.init_process_group("gloo")
    rank0_print(f"[mesh] process group: {dist.get_backend()} x "
                f"{dist.get_world_size()}")
    return dev, True


class _DeviceContext:
    """The mesh and its ParallelContext whenever a process group is up (any
    world size: a one-rank torchrun takes the sharded path too), else
    None: pipe x data x fsdp x expert x tensor = the world, the ranks the
    parallel flags leave over going to fsdp (llavamod_tpu/train/run.py
    `_DeviceContext`)."""

    def __init__(self, targs: TrainArgs, device):
        self.mesh = self.pctx = None
        launched, world = _launched()
        if not launched:
            return
        from llavamod_tpu_torch.parallel.collectives import ParallelContext
        from llavamod_tpu_torch.parallel.mesh import MeshConfig, make_mesh

        need = _mesh_need(targs)
        self.mesh = make_mesh(MeshConfig(
            data=targs.data_parallel, fsdp=world // need,
            expert=targs.expert_parallel, tensor=targs.tensor_parallel,
            pipe=targs.pipeline_parallel), torch.device(device).type)
        self.pctx = ParallelContext(self.mesh)
        rank0_print(f"[mesh] {dataclasses.asdict(self.pctx.cfg)}")

    def shard_models(self, model, teacher, tcfg: TrainConfig, lora=None):
        """Both models sharded over the mesh, parameters gathered in the
        compute dtype; LoRA adapters cut to the rank's part."""
        if self.pctx is None:
            return
        from llavamod_tpu_torch.parallel.sharding import (
            shard_lora,
            shard_params,
        )
        from llavamod_tpu_torch.train.steps import _DTYPES

        dtype = _DTYPES[tcfg.compute_dtype]
        for m in (model, teacher):
            if m is not None:
                shard_params(self.mesh, m, dtype, ctx=self.pctx)
        if lora is not None:
            shard_lora(lora, model, self.pctx)


# ---------------------------------------------------------------------------
# model construction
# ---------------------------------------------------------------------------

def build_llava(name_or_path: str, margs: ModelArgs, *, seed: int = 0,
                device="cuda"):
    """Resolve a model spec to (LlavaConfig, Llava) on `device`.

    A native checkpoint directory (llavamod_config.json + model.pt) loads
    in its stored dtype, an HF checkpoint directory (config.json; a
    released LLM or an HF LLaVA export) in its file's dtype, with any
    missing group ('vision', 'projector', 'llm') initialized fresh from
    `seed`; a registered preset name ('qwen1.5-0.5b', ...) is initialized
    from `seed` in float32."""
    from llavamod_tpu_torch.models import builder as model_builder
    from llavamod_tpu_torch.models import llava as llava_mod
    from llavamod_tpu_torch.models.llava import LlavaConfig
    from llavamod_tpu_torch.models.llm.config import llm_configs
    from llavamod_tpu_torch.models.vision.vit import vision_configs

    if os.path.isdir(name_or_path):
        if os.path.exists(os.path.join(name_or_path,
                                       model_builder.CONFIG_NAME)):
            return model_builder.load_model(name_or_path, device=device,
                                            fill_missing_seed=seed)
        return model_builder.import_hf_llava(
            name_or_path, projector_type=margs.image_projector_type,
            select_layer=margs.mm_vision_select_layer, device=device,
            fill_missing_seed=seed)
    cfg = LlavaConfig(
        llm=llm_configs.get(name_or_path),
        vision=vision_configs.get(margs.image_tower),
        projector_type=margs.image_projector_type,
        select_layer=margs.mm_vision_select_layer,
        select_feature=margs.mm_vision_select_feature,
        s2_scales=(tuple(int(s) for s in margs.s2_scales.split(","))
                   if margs.s2 else ()),
        # the video projector bundle (reference builder.py:125-205), on with
        # --video_tower; frames run through the IMAGE tower (the reference
        # stubs dedicated video towers out, multimodal_encoder/builder.py:39)
        video_projector_type=(margs.video_projector_type
                              if margs.video_tower else None),
        video_global_proj=margs.video_global_proj,
        video_temporal_proj=margs.video_temproal_proj,
        video_spatial_proj=margs.video_spatial_proj)
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


def maybe_add_image_tokens(cfg, model, margs: ModelArgs, tokenizer,
                           adapter: Optional[str] = None):
    """With --mm_use_im_start_end, `<im_start>` / `<im_end>` are added to
    the tokenizer and the policy's vocabulary grows by the rows of the new
    ids (`llava.initialize_vision_tokenizer`; the trainer's arguments have
    no --mm_use_im_patch_token, as in the JAX package)."""
    if not margs.mm_use_im_start_end:
        return cfg, model
    from llavamod_tpu_torch.models.llava import initialize_vision_tokenizer

    vocab = cfg.llm.vocab_size
    cfg, model = initialize_vision_tokenizer(
        model, cfg, tokenizer, mm_use_im_start_end=True,
        pretrain_mm_mlp_adapter=adapter)
    rank0_print(f"[build] image tokens added: vocabulary {vocab} -> "
                f"{cfg.llm.vocab_size}")
    return cfg, model


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


def maybe_add_lora(model, margs: ModelArgs, seed: int):
    """(adapters, LoraConfig), or (None, None) without --lora_enable: rank
    `lora_r`, alpha `lora_alpha`, on the FFN weights (experts included) with
    --only_lora_ffn, else also on attention; drawn from seed + 1."""
    if not margs.lora_enable:
        return None, None
    from llavamod_tpu_torch.models.lora import (
        DEFAULT_TARGETS,
        FFN_TARGETS,
        LoraConfig,
        init_lora,
    )

    lcfg = LoraConfig(r=margs.lora_r, alpha=margs.lora_alpha,
                      dropout=margs.lora_dropout,
                      target_patterns=FFN_TARGETS if margs.only_lora_ffn
                      else DEFAULT_TARGETS)
    device = next(model.llm.parameters()).device
    lora = init_lora(model, lcfg, torch.Generator(device=device)
                     .manual_seed(seed + 1))
    rank0_print(f"[build] LoRA adapters added (r={lcfg.r}, "
                f"ffn_only={margs.only_lora_ffn}, {len(lora.targets)} "
                f"targets)")
    return lora, lcfg


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

    video = cfg.video_projector_type is not None
    ds_cls = PreferenceJsonDataset if stage == "dpo" else SupervisedJsonDataset
    dataset = ds_cls(
        dargs.data_path, tokenizer, make_image_preprocessor(cfg),
        image_folder=dargs.image_folder, template_name=margs.version,
        model_max_length=targs.model_max_length,
        is_multimodal=dargs.is_multimodal,
        num_frames=cfg.num_video_frames if video else dargs.num_frames,
        use_im_start_end=margs.mm_use_im_start_end, seed=targs.seed,
        video_projector=video)
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    coll_cls = DPOCollator if stage == "dpo" else SupervisedCollator
    coll_kw = {}
    if stage != "dpo" and video:      # no video in the preference batches
        coll_kw = dict(num_video_tokens=cfg.num_video_tokens,
                       num_video_frames=cfg.num_video_frames)
    collator = coll_cls(max_len=targs.model_max_length,
                        num_image_tokens=cfg.num_image_tokens,
                        image_size=cfg.vision.image_size,
                        max_images=cfg.max_images, pad_id=pad_id, **coll_kw)
    if targs.group_by_modality_length:
        sampler = LengthGroupedSampler(
            targs.per_device_train_batch_size,
            world_size=targs.gradient_accumulation_steps,
            lengths=dataset.modality_lengths,
            group_by_modality=True, seed=targs.seed)
    else:
        sampler = RandomSampler(len(dataset), seed=targs.seed)
    _, world = _launched()
    stage_ranks = world // targs.pipeline_parallel
    rows = stage_ranks // targs.tensor_parallel
    if rows > 1:
        # every process loads only its row rank's strided shard of the
        # (deterministic, identically seeded) global order (reference
        # llava_trainer.py:62-90); the ranks of a tensor group (consecutive
        # ranks) and of a pipe group (the same place in every stage) read
        # the same rows
        from llavamod_tpu_torch.train.sampler import ProcessShardSampler
        from llavamod_tpu_torch.utils.logging import process_rank

        sampler = ProcessShardSampler(
            sampler, process_rank() % stage_ranks // targs.tensor_parallel,
            rows)
        rank0_print(f"[data] process-sharded sampler: {rows} shards")
    return DataLoader(dataset, targs.per_device_train_batch_size, collator,
                      sampler=sampler, drop_last=True,
                      num_workers=targs.dataloader_num_workers)


# ---------------------------------------------------------------------------
# metric logging
# ---------------------------------------------------------------------------

class MetricLogger:
    """Accumulate step metrics; emit means every logging_steps (reference
    store_metrics/log, align_trainer.py:596-614) to the console, to
    <output_dir>/metrics.jsonl, and to wandb when available; on rank 0
    only (the metrics are the world's on every rank)."""

    def __init__(self, targs: TrainArgs, total_steps: int):
        self.every = max(1, targs.logging_steps)
        self.total = total_steps
        self.acc: Dict[str, float] = {}
        self.n = 0
        self.t0 = time.time()
        self.wandb = None
        self.jsonl = None
        from llavamod_tpu_torch.utils.logging import process_rank

        if process_rank() != 0:
            return
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
                   cfg, save_total_limit: Optional[int], pctx=None):
    from llavamod_tpu_torch.train.checkpoint import (
        gather_full_state,
        save_checkpoint,
        save_mm_projector,
        save_sharded_checkpoint,
    )

    if pctx is None:
        path = save_checkpoint(output_dir, step, state)
        projector = state.model.projector.state_dict()
    else:
        path = save_sharded_checkpoint(output_dir, step, state, pctx)
        projector = gather_full_state(state.model.projector, pctx)
    rank0_print(f"[ckpt] saved {path}")
    if projector is not None and (tcfg.tune_mm_mlp_adapter
                                  or tcfg.stage == "pretrain"):
        # stage-1 semantics: the artifact of record is mm_projector.bin
        save_mm_projector(os.path.join(path, "mm_projector.bin"), projector,
                          cfg.projector_type)
    if pctx is not None:
        torch.distributed.barrier()
    if save_total_limit and (pctx is None or pctx.rank == 0):
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

def quantize_stage_models(tcfg: TrainConfig, stage_args, model, teacher,
                          lora_cfg=None) -> Dict[str, Any]:
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

    With LoRA the student is left as it is, as in the JAX engine: its head
    is quantized per step from the live weights (train/steps.py) and its
    body stays in float.  Returns the host stash that `float_state` puts
    back for the export."""
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
    if lora_cfg is not None:
        return stash
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


def float_state(state: Dict[str, torch.Tensor], stash: Dict[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """The model's state dict for the export: the float head and body of
    `stash` in place of their int8 entries (training-time stand-ins that
    never moved), the routers that trained kept."""
    layers = stash.get("layers", ())
    out: Dict[str, torch.Tensor] = {}
    done = set()
    for k, v in state.items():
        if "head" in stash and k.startswith("llm.lm_head.weight."):
            if "head" not in done:
                out["llm.lm_head.weight"] = stash["head"]
                done.add("head")
            continue
        m = re.match(r"^llm\.layers\.(\d+)\.", k)
        if m and int(m.group(1)) < len(layers):
            i = int(m.group(1))
            if i not in done:
                pre = f"llm.layers.{i}."
                for lk, lv in layers[i].state_dict().items():
                    out[pre + lk] = (state[pre + lk] if lk == "mlp.router"
                                     else lv.detach().cpu())
                done.add(i)
            continue
        out[k] = v
    return out


def final_save(output_dir: str, cfg, state, tcfg: TrainConfig,
               stash: Dict[str, Any], lora_cfg=None, pctx=None) -> None:
    """The full model (llavamod_config.json + model.pt), its int8 stand-ins
    replaced by `float_state`; with LoRA the adapters first go to
    `output_dir/adapter` in PEFT's layout, with the run's other trained
    tensors in `non_lora_trainables.bin`, and are then merged into the
    model saved; stage 1 also exports mm_projector.bin (reference
    train.py:535-557).  Under torch.distributed every rank takes part in
    gathering the model and the adapters, and rank 0 writes them, in the
    same format, the merge computed on its card."""
    from llavamod_tpu_torch.models.builder import save_model
    from llavamod_tpu_torch.train.checkpoint import (
        gather_full_state,
        gather_lora,
        save_mm_projector,
        stage_trainables,
    )

    from llavamod_tpu_torch.models.lora import (
        merge_lora_,
        merge_lora_state_,
        save_lora_adapter,
        save_non_lora_trainables,
    )

    adapter = os.path.join(output_dir, "adapter")
    if pctx is None:
        if state.lora is not None:
            save_lora_adapter(adapter, state.lora, lora_cfg)
            save_non_lora_trainables(adapter, state.model)
            merge_lora_(state.model, state.lora, lora_cfg)
        full = state.model.state_dict()
    else:
        full = gather_full_state(state.model, pctx)
        lora = (gather_lora(state.lora, pctx) if state.lora is not None
                else None)
        trainable = (stage_trainables(state.model, pctx)
                     if state.lora is not None else None)
        if lora is not None:            # rank 0
            save_lora_adapter(adapter, lora, lora_cfg)
            save_non_lora_trainables(adapter, state.model, full, trainable)
            merge_lora_state_(full, lora, lora_cfg, device=next(
                state.lora.parameters()).device)
    if full is not None:
        full = float_state(full, stash)
        save_model(output_dir, state.model, full)
        if tcfg.tune_mm_mlp_adapter or tcfg.stage == "pretrain":
            pre = "projector."
            save_mm_projector(os.path.join(output_dir, "mm_projector.bin"),
                              {k[len(pre):]: v for k, v in full.items()
                               if k.startswith(pre)}, cfg.projector_type)
        rank0_print(f"[ckpt] final model saved to {output_dir}")
    if pctx is not None:
        torch.distributed.barrier()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def build_stage_models(stage: str, margs: ModelArgs, targs: TrainArgs,
                       salign: Optional[AlignArgs] = None,
                       sdpo: Optional[DPOArgs] = None, device="cuda",
                       tokenizer=None):
    """(cfg, model, teacher_cfg, teacher) for `stage`: the policy (with its
    adapter loaded, its vocabulary grown by the image tokens with
    --mm_use_im_start_end and, where asked, upcycled to MoE) and, for align
    and dpo, the frozen teacher / reference model (None otherwise)."""
    policy_spec = margs.model_name_or_path
    teacher_cfg = teacher = None
    if stage == "align":
        policy_spec = salign.policy_model_name_or_path or policy_spec
        cfg, model = build_llava(policy_spec, margs, seed=targs.seed,
                                 device=device)
        adapter = (salign.policy_pretrain_mm_mlp_adapter
                   or margs.pretrain_mm_mlp_adapter)
        maybe_load_mm_adapter(model, adapter, cfg.projector_type)
        cfg, model = maybe_add_image_tokens(cfg, model, margs, tokenizer,
                                            adapter)
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
        cfg, model = maybe_add_image_tokens(cfg, model, margs, tokenizer)
        teacher_cfg, teacher = build_llava(
            sdpo.ref_model_name_or_path, margs, seed=targs.seed + 7,
            device=device)
    else:
        cfg, model = build_llava(policy_spec, margs, seed=targs.seed,
                                 device=device)
        maybe_load_mm_adapter(model, margs.pretrain_mm_mlp_adapter,
                              cfg.projector_type)
        cfg, model = maybe_add_image_tokens(cfg, model, margs, tokenizer,
                                            margs.pretrain_mm_mlp_adapter)
        if margs.moe_enable and not targs.moe_finetune:
            cfg, model = maybe_upcycle(cfg, model, margs)
    if teacher is not None:
        teacher.requires_grad_(False)
        if (margs.mm_use_im_start_end
                and teacher_cfg.llm.vocab_size < cfg.llm.vocab_size):
            raise ValueError(
                f"the teacher's vocabulary ({teacher_cfg.llm.vocab_size}) "
                f"lacks ids of the policy's ({cfg.llm.vocab_size}): "
                "--mm_use_im_start_end grows the policy only; the teacher "
                "must come with the image tokens")
    return cfg, model, teacher_cfg, teacher


def run_stage(stage: str, margs: ModelArgs, dargs: DataArgs, targs: TrainArgs,
              salign: Optional[AlignArgs] = None,
              sdpo: Optional[DPOArgs] = None,
              tokenizer=None, device="cuda") -> Dict[str, float]:
    """Run one full training stage on `device` (under torchrun, sharded
    over the world's cards); returns the last logged metrics."""
    assert stage in ("pretrain", "finetune", "align", "dpo"), stage
    refuse_unported(margs, targs)
    device, started = init_distributed(device)
    try:
        return _run_stage(stage, margs, dargs, targs, salign, sdpo, tokenizer,
                          device)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _run_stage(stage, margs, dargs, targs, salign, sdpo, tokenizer, device):
    from llavamod_tpu_torch.parallel.collectives import active
    from llavamod_tpu_torch.runtime.prefetch import DevicePrefetcher
    from llavamod_tpu_torch.train.checkpoint import maybe_auto_resume
    from llavamod_tpu_torch.train.fused_steps import (
        init_fused_state,
        make_fused_align_step,
    )
    from llavamod_tpu_torch.train.loader import (
        fold_microbatches,
        infinite_batches,
    )
    from llavamod_tpu_torch.train.optim import TrainState
    from llavamod_tpu_torch.train.steps import (
        _can_share_tower,
        batch_from_arrays,
        make_align_step,
        make_dpo_step,
        make_pretrain_step,
    )

    dev = _DeviceContext(targs, device)
    pctx = dev.pctx
    t_build = time.perf_counter()
    if tokenizer is None:
        tokenizer = load_tokenizer(margs)
    cfg, model, teacher_cfg, teacher = build_stage_models(
        stage, margs, targs, salign, sdpo, device, tokenizer)
    if stage == "align" and cfg.video_projector_type is not None:
        # the distillation batch indexes the student's video rows, which the
        # teacher's media table lacks (the JAX engine reads past its table;
        # the preference batches carry no video)
        raise ValueError("the video projector does not train in the align "
                         "stage: its teacher cannot read the video rows")

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
    if targs.sequence_parallel and targs.tensor_parallel > 1:
        cfg = cfg.replace(llm=cfg.llm.replace(seq_shard_activations=True))
        if teacher_cfg is not None:
            teacher_cfg = teacher_cfg.replace(
                llm=teacher_cfg.llm.replace(seq_shard_activations=True))
        rank0_print("[mesh] sequence parallelism on: residual stream "
                    f"T-sharded over tensor={targs.tensor_parallel}")
    if targs.pipeline_parallel > 1:
        mb = targs.pipeline_microbatches
        cfg = cfg.replace(llm=cfg.llm.replace(pipeline_microbatches=mb))
        if teacher_cfg is not None:
            teacher_cfg = teacher_cfg.replace(
                llm=teacher_cfg.llm.replace(pipeline_microbatches=mb))
        rank0_print(f"[mesh] pipeline parallelism on: "
                    f"pipe={targs.pipeline_parallel}, "
                    f"microbatches={mb or targs.pipeline_parallel}")
    lora, lora_cfg = maybe_add_lora(model, margs, targs.seed)
    float_stash = quantize_stage_models(tcfg, salign or sdpo, model, teacher,
                                        lora_cfg)

    # (prestack_layers has no effect: the JAX package pre-stacks the layer
    # trees for its lax.scan layer loop, a TPU workaround the port does not
    # carry)

    # loop budget: total_steps is in MICROBATCHES.  A fused step is one
    # optimizer update over `accum` folded microbatches, so its call budget
    # is total / accum: both paths see the same data and apply the same
    # number of updates.
    accum = max(1, tcfg.grad_accum_steps)
    fused = targs.fused_update
    loop_total = max(1, total_steps // accum) if fused else total_steps
    if fused:
        if stage != "align":
            raise ValueError("--fused_update is align-stage only")
        if lora is not None:
            raise ValueError("--fused_update does not support LoRA")
        if accum > 1:
            rank0_print(f"[fused] in-batch gradient accumulation: {accum} "
                        f"microbatches folded per update; running "
                        f"{loop_total} update steps (= {total_steps} "
                        f"microbatches)")
    dev.shard_models(model, teacher, tcfg, lora)
    if fused:
        state = init_fused_state(model, cfg, tcfg, pctx=pctx)
    else:
        state = TrainState.create(model, tcfg, lora_cfg, lora, pctx)
    state, resumed = maybe_auto_resume(targs.output_dir, state, pctx)
    if resumed:
        rank0_print(f"[ckpt] auto-resumed from {resumed}")
    start_step = int(state.step)
    build_s = time.perf_counter() - t_build

    if stage == "align":
        step_fn = (make_fused_align_step(cfg, teacher_cfg, tcfg) if fused
                   else make_align_step(cfg, teacher_cfg, tcfg, lora_cfg))
        call = lambda st, b: step_fn(  # noqa: E731
            st, teacher, batch_from_arrays(b, device=device))
    elif stage == "dpo":
        step_fn = make_dpo_step(cfg, teacher_cfg, tcfg, lora_cfg)
        call = lambda st, b: step_fn(st, teacher, b)  # noqa: E731
    else:
        step_fn = make_pretrain_step(cfg, tcfg, lora_cfg)
        call = lambda st, b: step_fn(  # noqa: E731
            st, batch_from_arrays(b, device=device))

    logger = MetricLogger(targs, loop_total)
    os.makedirs(targs.output_dir, exist_ok=True)
    rank0 = pctx is None or pctx.rank == 0
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
    batches = (fold_microbatches(host_batches, accum, rows_per_sample=(
        cfg.max_images * cfg.num_image_tokens + cfg.num_video_tokens))
        if fused else host_batches)
    # a resumed run continues the data where its checkpoint left it, as the
    # reference's Trainer skips the batches an interrupted epoch has seen
    # (the JAX engine restarts the order; ROADMAP Queue 3)
    for _ in range(start_step):
        next(batches)
    profiler = None
    save_s = 0.0
    stop = False
    t_loop = time.perf_counter()
    try:
        for batch in DevicePrefetcher(batches, device=device):
            if step_no >= loop_total or stop:
                break
            if targs.profile_steps and step_no == start_step + 1 and rank0:
                profiler = _start_profiler(device)
            with active(pctx):
                state, metrics = call(state, batch)
            step_no += 1
            last_metrics = {k: float(v) for k, v in metrics.items()}
            logger.update(step_no, last_metrics)
            if profiler is not None and \
                    step_no >= start_step + 1 + targs.profile_steps:
                _stop_profiler(profiler, targs.output_dir)
                profiler = None
            save = (targs.save_steps and step_no % targs.save_steps == 0
                    and step_no < loop_total)
            stop = _stop(stop_requested, pctx, save or step_no % max(
                1, targs.logging_steps) == 0)
            if stop or save:
                t_save = time.perf_counter()
                _save_periodic(targs.output_dir, step_no, state, tcfg, cfg,
                               targs.save_total_limit, pctx)
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
    final_save(targs.output_dir, cfg, state, tcfg, float_stash, lora_cfg,
               pctx)
    save_s += time.perf_counter() - t_save
    info = {"stage": stage, "build_and_load_s": build_s, "loop_s": loop_s,
            "save_s": save_s,
            "microbatches": (step_no - start_step) * (accum if fused else 1),
            "step": step_no, "optimizer_updates": state.opt.updates,
            "resumed_from": resumed}
    if pctx is not None:
        info["mesh"] = dataclasses.asdict(pctx.cfg)
        info["backend"] = torch.distributed.get_backend()
    if rank0:
        with open(os.path.join(targs.output_dir, "run_info.json"), "w") as f:
            json.dump(info, f, indent=1)
    return last_metrics


def _stop(stop_requested, pctx, agree: bool) -> bool:
    """A SIGTERM reached this process.  Under a mesh any rank's counts, and
    the ranks agree on it (one all-reduce) only at the steps where `agree`
    (save and logging steps), so they stop and checkpoint at the same
    step."""
    if pctx is None:
        return bool(stop_requested)
    if not agree:
        return False
    flag = torch.tensor([1.0 if stop_requested else 0.0],
                        device=pctx.device_type)
    torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
    return bool(flag.item())


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
    """The model directory's tokenizer: its tiktoken vocabulary (qwen-1.0,
    stablelm's arcade100k), else its HF tokenizer files (transformers,
    imported here only)."""
    from llavamod_tpu_torch.interop.tiktoken_tokenizers import (
        load_tiktoken_tokenizer,
    )

    path = margs.model_name_or_path
    tok = load_tiktoken_tokenizer(path)
    if tok is not None:
        return tok
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
