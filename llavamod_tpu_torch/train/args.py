"""Argument dataclasses + CLI parser for the train entry points (port of
llavamod_tpu/train/args.py).

The same five dataclasses with the same fields and defaults as the JAX
package (tests/test_torch_config.py holds them equal), so one command line
or `--config` JSON means the same in both packages.  Fields of mechanisms
the port does not run yet are kept for that reason; `train/run.py` raises
NotImplementedError on them, naming the ROADMAP item that ports them.
`parse_into_dataclasses` is a small HfArgumentParser equivalent: every
dataclass field becomes a `--flag`; bools accept true/false; List fields
accept repeated values; `--config` JSON fills only the flags the command
line did not give.  That is the one difference from the JAX parser, which
fills every flag whose value equals its default, so that there
`--ref_quant ""` cannot undo a config's `int8_head` although its help says
the command line overrides the config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional, Sequence, Tuple, Type

from llavamod_tpu_torch.train.config import TrainConfig


@dataclasses.dataclass
class ModelArgs:
    model_name_or_path: str = "qwen1.5-0.5b"   # preset name or checkpoint dir
    version: str = "qwen"                      # conversation template
    freeze_backbone: bool = False
    tune_mm_mlp_adapter: bool = False
    pretrain_mm_mlp_adapter: Optional[str] = None  # mm_projector.bin path
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    mm_use_im_start_end: bool = False
    s2: bool = False                           # S2 multi-scale tower
    s2_scales: str = "336,672"
    image_tower: str = "clip-vit-l-336"
    image_projector_type: str = "mlp2x_gelu"

    # --- video projector ('temproal' keeps the reference's CLI spelling) ---
    video_tower: Optional[str] = None
    video_projector_type: str = "linear"
    video_global_proj: bool = False
    video_temproal_proj: bool = False
    video_spatial_proj: bool = False

    # --- LoRA ---
    lora_enable: bool = False
    lora_r: int = 128
    lora_alpha: int = 256
    lora_dropout: float = 0.05
    only_lora_ffn: bool = True

    # --- MoE (reference config/args.py:36-58) ---
    moe_enable: bool = False
    moe_mode: str = "sparse"
    moe_layers_idx: Optional[List[int]] = None
    ep_size: int = 1
    num_experts: int = 4
    top_k_experts: int = 2
    capacity_factor: float = 1.5
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    use_residual: bool = False
    router_aux_loss_coef: float = 0.01
    train_modules: Optional[List[str]] = None


@dataclasses.dataclass
class DataArgs:
    data_path: List[str] = dataclasses.field(default_factory=list)
    image_folder: str = ""
    is_multimodal: bool = True
    image_aspect_ratio: str = "pad"
    num_frames: int = 8


@dataclasses.dataclass
class TrainArgs:
    output_dir: str = "./output"
    per_device_train_batch_size: int = 8
    # max_steps and epoch-derived step counts are in MICROBATCHES; with
    # accumulation (MultiSteps) the optimizer updates every accum calls and
    # the LR schedule runs over total / accum updates
    gradient_accumulation_steps: int = 1
    num_train_epochs: float = 1.0
    max_steps: int = -1                 # -1 = derive from epochs
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    optimizer: str = "adamw"            # adamw | adafactor
    # align stage + adafactor: the fused backward+update step
    # (train/fused_steps.py); accumulation is folded into the batch axis
    fused_update: bool = False
    # pretrain/SFT: split the batch into N row chunks inside the step and
    # sum token-weighted per-chunk gradients (exact full-batch gradients,
    # activations held for one chunk).  0/1 = off; must divide the batch.
    grad_row_chunks: int = 1
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_scheduler_type: str = "cosine"
    max_grad_norm: float = 1.0
    logging_steps: int = 1
    save_steps: int = 500
    save_total_limit: Optional[int] = None
    model_max_length: int = 2048
    group_by_modality_length: bool = False
    freeze_mm_mlp_adapter: bool = False
    moe_finetune: bool = False
    distill_all_tokens: bool = False
    seed: int = 42
    dataloader_num_workers: int = 8
    report_to: str = "none"             # none | wandb (gated on availability)
    run_name: Optional[str] = None
    # trace N steps: output_dir/profile/trace.json (torch.profiler) and
    # spans.json (the program's spans, runtime/trace.py, on its clock)
    profile_steps: int = 0
    compute_dtype: str = "bfloat16"
    remat: bool = True
    attn_impl: str = "auto"
    vocab_chunk: int = 2048
    # mesh axes under torchrun, one process per card (train/run.py
    # `_DeviceContext`: pipe x data x fsdp x expert x tensor = the world,
    # the ranks left over go to fsdp): data, expert, tensor, sequence and
    # pipeline parallelism run, --lora_enable on any of them, --fused_update
    # on all but the pipeline
    expert_parallel: int = 1            # ranks that split the experts
    tensor_parallel: int = 1            # ranks that split heads, F, vocab
    data_parallel: int = 1              # replicas (HSDP over data x expert)
    sequence_parallel: bool = False     # T-sharded stream (tensor > 1)
    pipeline_parallel: int = 1          # GPipe stages (parallel/pipeline.py)
    pipeline_microbatches: int = 0      # 0 = one microbatch per stage
    # accepted and without effect: the JAX package pre-stacks the layer
    # trees for its lax.scan layer loop, a TPU workaround the port does not
    # carry (its layers are a Python loop over modules)
    prestack_layers: bool = True


@dataclasses.dataclass
class AlignArgs:
    """Mimic distillation (reference config/args.py:113-121)."""
    policy_model_type: str = "sparse"   # sparse | dense
    ref_model_type: str = "dense"
    loss_type: str = "only_kd"          # only_kd | kd_lm
    policy_model_name_or_path: Optional[str] = None
    policy_pretrain_mm_mlp_adapter: Optional[str] = None
    ref_model_name_or_path: Optional[str] = None
    ref_pretrain_mm_mlp_adapter: Optional[str] = None
    moe_loss_enable: bool = False
    kd_vocab_limit: Optional[int] = None
    # int8 W8A8 teacher, student head and body and their loss modes
    # (train/run.py `quantize_stage_models`, ops/losses.py)
    ref_quant: str = ""                 # '' | 'int8' | 'int8_head'
    policy_head_quant: bool = False
    policy_body_quant: bool = False
    kd_int8_dh: bool = False
    kd_stream_dh: bool = False


@dataclasses.dataclass
class DPOArgs:
    """Preference distillation (reference config/args.py:124-131)."""
    policy_model_type: str = "sparse"
    ref_model_type: str = "dense"
    loss_type: str = "sigmoid"          # sigmoid | hinge | ipo | kto_pair
    policy_model_name_or_path: Optional[str] = None
    ref_model_name_or_path: Optional[str] = None
    moe_loss_enable: bool = False
    dpo_beta: float = 0.1
    dpo_label_smoothing: float = 0.0
    ref_quant: str = ""                 # '' | 'int8' | 'int8_head' (W8A8 ref)


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def _add_dataclass_args(parser: argparse.ArgumentParser, cls: Type,
                        suppress: bool = False) -> None:
    group = parser.add_argument_group(cls.__name__)
    for f in dataclasses.fields(cls):
        name = "--" + f.name
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        if suppress:
            default = argparse.SUPPRESS
        ann = str(f.type)   # annotation strings (from __future__ annotations)
        if "bool" in ann:
            group.add_argument(name, type=_str2bool, default=default)
        elif "List[int]" in ann:
            group.add_argument(name, type=int, nargs="+", default=default)
        elif "List[str]" in ann:
            group.add_argument(name, type=str, nargs="+", default=default)
        elif "int" in ann:
            group.add_argument(name, type=int, default=default)
        elif "float" in ann:
            group.add_argument(name, type=float, default=default)
        else:
            group.add_argument(name, type=str, default=default)


def _parser(classes: Sequence[Type], prog: str,
            suppress: bool = False) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument("--config", type=str, default=None,
                        help="JSON file of flag defaults (CLI overrides it)")
    for cls in classes:
        _add_dataclass_args(parser, cls, suppress)
    return parser


def parse_into_dataclasses(classes: Sequence[Type],
                           argv: Optional[Sequence[str]] = None,
                           prog: str = "llavamod_tpu_torch.train") -> Tuple:
    ns, unknown = _parser(classes, prog).parse_known_args(argv)
    if unknown:
        raise SystemExit(f"unknown arguments: {unknown}")
    values = vars(ns)
    if ns.config:
        with open(ns.config) as fh:
            overrides = json.load(fh)
        # the config file fills only the flags the command line did not
        # give: a second parse without defaults names those it did
        given = vars(_parser(classes, prog, suppress=True)
                     .parse_known_args(argv)[0])
        for k, v in overrides.items():
            if k in values and k not in given:
                values[k] = v
    return tuple(cls(**{f.name: values[f.name] for f in dataclasses.fields(cls)})
                 for cls in classes)


def train_config_from_args(stage: str, targs: TrainArgs, total_steps: int,
                           model_args: Optional[ModelArgs] = None,
                           align: Optional[AlignArgs] = None,
                           dpo: Optional[DPOArgs] = None) -> TrainConfig:
    """Fold the CLI dataclasses into the step's TrainConfig.

    total_steps is in MICROBATCHES; the LR schedule advances once per
    optimizer step (MultiSteps), so it gets total / accum."""
    accum = max(1, targs.gradient_accumulation_steps)
    kw = dict(
        learning_rate=targs.learning_rate,
        mm_projector_lr=targs.mm_projector_lr,
        optimizer=targs.optimizer,
        weight_decay=targs.weight_decay,
        max_grad_norm=targs.max_grad_norm,
        warmup_ratio=targs.warmup_ratio,
        lr_schedule=targs.lr_scheduler_type,
        total_steps=max(1, total_steps // accum),
        grad_accum_steps=targs.gradient_accumulation_steps,
        grad_row_chunks=targs.grad_row_chunks,
        seed=targs.seed,
        stage=stage,
        moe_finetune=targs.moe_finetune,
        distill_all_tokens=targs.distill_all_tokens,
        freeze_mm_mlp_adapter=targs.freeze_mm_mlp_adapter,
        compute_dtype=targs.compute_dtype,
        remat=targs.remat,
        attn_impl=targs.attn_impl,
        vocab_chunk=targs.vocab_chunk,
    )
    if model_args is not None:
        kw["tune_mm_mlp_adapter"] = model_args.tune_mm_mlp_adapter
        if model_args.train_modules:
            kw["train_modules"] = tuple(model_args.train_modules)
    if align is not None:
        kw["align_loss_type"] = align.loss_type
        kw["moe_loss_enable"] = align.moe_loss_enable
        kw["kd_vocab_limit"] = align.kd_vocab_limit
        if align.policy_head_quant:
            if not (model_args and model_args.train_modules):
                raise ValueError(
                    "--policy_head_quant requires explicit --train_modules "
                    "that freeze the LM head — quantizing a TRAINED head "
                    "would silently stop its gradients")
            kw["student_head_quant"] = True
        kw["kd_int8_dh"] = align.kd_int8_dh
        kw["kd_stream_dh"] = align.kd_stream_dh
        if align.policy_body_quant:
            if not (model_args and model_args.train_modules):
                raise ValueError(
                    "--policy_body_quant requires explicit --train_modules "
                    "that freeze every decoder weight except the router — "
                    "quantizing TRAINED weights would silently stop their "
                    "gradients")
            kw["student_body_quant"] = True
    if dpo is not None:
        kw["dpo_loss_type"] = dpo.loss_type
        kw["dpo_beta"] = dpo.dpo_beta
        kw["dpo_label_smoothing"] = dpo.dpo_label_smoothing
        kw["moe_loss_enable"] = dpo.moe_loss_enable
    return TrainConfig(**kw)
