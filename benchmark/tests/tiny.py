"""Tiny configurations and cells of the benchmark's own CPU tests: the
real layouts (MoE on the even layers, a CLIP-style tower, the
mlp2x_gelu projector, the full Qwen vocabulary that the stand-in
tokenizer's ids need) at widths a CPU runs in seconds."""

import contextlib
import copy

from benchmark.harness import common

VISION = {"name": "tiny-vit", "image_size": 28, "patch_size": 14,
          "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 4, "layer_norm_eps": 1e-05,
          "hidden_act": "quick_gelu"}

STUDENT = {"name": "tiny-moe", "architecture": "llava_qwen",
           "vocab_size": 151936, "hidden_size": 64,
           "intermediate_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
           "max_position_embeddings": 4096, "rope_theta": 1000000.0,
           "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
           "qkv_bias": True, "mm_projector_type": "mlp2x_gelu",
           "mm_vision_select_layer": -2, "mm_vision_select_feature": "patch",
           "image_aspect_ratio": "pad", "vision_config": VISION,
           "moe": {"num_experts": 4, "num_experts_per_tok": 2,
                   "moe_mode": "sparse", "capacity_factor": 1.5,
                   "eval_capacity_factor": 2.0, "min_capacity": 4,
                   "use_residual": False, "router_aux_loss_coef": 0.01}}

TEACHER = dict(copy.deepcopy(STUDENT), name="tiny-dense", hidden_size=96,
               num_attention_heads=6, num_key_value_heads=6, head_dim=16)
del TEACHER["moe"]

CONVERSATIONS = {"kind": "conversations", "records": 8, "epochs": 3,
                 "images": 3, "image_sizes": [[64, 48], [40, 56], [50, 50]],
                 "real_tokens": [240, 320], "question_chars": [8, 20],
                 "answer_chars": [20, 60]}

QUESTIONS = {"kind": "questions", "clients": 4, "pool": 16, "images": 3,
             "image_sizes": [[64, 48], [40, 56], [50, 50]],
             "question_tokens": [8, 24], "max_new_tokens": [1, 2, 3, 4]}

DISTILL = {"driver": "distill", "chips": 1, "config": "tiny-moe",
           "teacher": "tiny-dense", "traffic": "tiny-conversations",
           "recipe": "llavamod_tpu_torch/recipes/train/dense2sparse_distillation.sh",
           "extra_flags": ["--model_max_length", "384",
                           "--dataloader_num_workers", "2"],
           "limits": {"loss": 1e-3, "loss_after": 3e-5, "first_grad": 1e-2,
                      "mean_grad": 5e-2, "update": 1e-2}}

# the distillation cell on four ranks (gloo on the CPU): two experts a rank
# and the rest of the mesh on fsdp, an update every 2 microbatches.  Sound
# runs read up to loss 3.7e-5, loss_after 4.4e-5, first_grad 0.032 (a
# router), mean_grad 0.022, update 2.6e-4 over 5 seeds; the control reads
# first_grad 0.073, mean_grad 0.068, half the accumulation mean_grad 0.059,
# the flipped update loss_after 1.2e-4
DISTILL_DIST = dict(DISTILL, driver="distill_dist", chips=4,
                    extra_flags=DISTILL["extra_flags"] + [
                        "--gradient_accumulation_steps", "2",
                        "--expert_parallel", "2"],
                    limits={"loss": 1e-3, "loss_after": 8e-5,
                            "first_grad": 0.05, "mean_grad": 0.04,
                            "update": 1e-2})

SERVE = {"driver": "serve", "chips": 1, "config": "tiny-moe",
         "traffic": "tiny-questions",
         "engine": {"max_batch": 2, "batch_window": 0.02,
                    "max_prompt_len": 320, "template": "qwen",
                    "timeout_s": 120, "warm_batches": 1},
         "check": {"requests": 16, "min_tokens": 16},
         "limits": {"mean_logit_gap": 1.5e-3}}

FILES = {"tiny-moe": STUDENT, "tiny-dense": TEACHER,
         "tiny-conversations": CONVERSATIONS, "tiny-questions": QUESTIONS}


@contextlib.contextmanager
def tiny_files():
    """common.config / common.traffic find the tiny files by name."""
    saved = common.config, common.traffic
    common.config = lambda name: copy.deepcopy(FILES[name])
    common.traffic = lambda name: copy.deepcopy(FILES[name])
    try:
        yield
    finally:
        common.config, common.traffic = saved
