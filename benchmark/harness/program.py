"""The program under test, as the drivers build it: its configuration
objects from a configuration file, and its model from the benchmark's
seeded weights through its own checkpoint path (`builder.from_state`,
which builds on the meta device and adopts the tensors as they are)."""

from __future__ import annotations

import torch

from benchmark.harness import common
from benchmark.harness import weights as wmod


def llava_config(cfg: dict):
    """The program's LlavaConfig: the tower and projector from the
    configuration's keys, the decoder from its architecture
    (benchmark/harness/arch/<architecture>.py `decoder_config`)."""
    from llavamod_tpu_torch.models.llava import LlavaConfig
    from llavamod_tpu_torch.models.llm.config import DecoderConfig
    from llavamod_tpu_torch.models.vision.vit import VisionConfig

    v = cfg["vision_config"]
    llm = DecoderConfig(**common.architecture(cfg, "harness")
                        .decoder_config(cfg))
    vision = VisionConfig(
        name=v["name"], image_size=v["image_size"], patch_size=v["patch_size"],
        hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
        num_layers=v["num_hidden_layers"], num_heads=v["num_attention_heads"],
        layer_norm_eps=v["layer_norm_eps"])
    return LlavaConfig(llm=llm, vision=vision,
                       projector_type=cfg["mm_projector_type"],
                       select_layer=cfg["mm_vision_select_layer"],
                       select_feature=cfg["mm_vision_select_feature"],
                       image_aspect_ratio=cfg["image_aspect_ratio"])


def build(cfg: dict, seed: int, tag: str, device, dtype: torch.dtype,
          vision: bool = True):
    """(program config, program model) holding the seeded weights."""
    import time

    from benchmark.harness.common import log
    from llavamod_tpu_torch.models import builder

    pcfg = llava_config(cfg)
    t0 = time.perf_counter()
    state = wmod.make_state(cfg, seed, tag, device, dtype, vision=vision)
    if str(device) != "cpu":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    model = builder.from_state(pcfg, state, "benchmark", device, dtype, None,
                               drop_missing=not vision)
    del state
    log(f"[setup] {cfg['name']} ({tag}): weights drawn in {t1 - t0:.2f} s, "
        f"model built in {time.perf_counter() - t1:.2f} s")
    return pcfg, model
