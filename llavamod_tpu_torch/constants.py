"""Framework-wide constants.

Parity notes: values match the reference's `llavamod/constants.py:1-26` so that
datasets, checkpoints, and prompts are interchangeable.

The port's own copy of llavamod_tpu/constants.py.
"""

# Token-level sentinels (same values as reference constants.py:6-8).
IGNORE_INDEX = -100          # label value for positions excluded from the loss
IMAGE_TOKEN_INDEX = -200     # splice marker produced by tokenize_with_images
# TPU-side extra: one marker for a WHOLE video when the video projector is
# active.  The reference has no such index — it expands <video> into
# num_frames x <image> (data_utils.py:125-151) because its video projector
# path consumes per-frame features ad hoc; here the splice needs one
# placeholder that expands to video_projector.num_output_tokens slots.
VIDEO_TOKEN_INDEX = -201

# Prompt-level placeholder strings (reference constants.py:10-21).
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
DEFAULT_VID_START_TOKEN = "<vid_start>"
DEFAULT_VID_END_TOKEN = "<vid_end>"

# Per-sample media budget (reference constants.py:23-24).
MAX_IMAGE_LENGTH = 16
MAX_VIDEO_LENGTH = 1

# Logging/server defaults (reference constants.py:2-4).
LOGDIR = "."
WORKER_HEART_BEAT_INTERVAL = 15

# Default sequence length of record (reference shells/train/qwen/pretrain.sh:53).
DEFAULT_MAX_LENGTH = 2048
