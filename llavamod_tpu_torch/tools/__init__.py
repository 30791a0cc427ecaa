"""Checkpoint manipulation tools (port of llavamod_tpu/tools: import_hf,
extract_mm_projector, consolidate, delta, merge_lora)."""
