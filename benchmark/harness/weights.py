"""Seeded weights of a LLaVA configuration, made on the device.

The names and shapes are the program's checkpoint layout (its state-dict
keys, the JAX parameter paths: 'llm.layers.3.attn.wq' [D, H*dh] used as
x @ w, stacked experts [E, D, F], a [V, D] head), written out here from the
configuration file, so the reference reads the same tensors under the same
names without importing the program: the tower and the projector here,
the decoder by the configuration's architecture
(benchmark/harness/arch/<architecture>.py `groups`).

Each group of parameters (the tower's stem, each tower layer, the
projector, the embedding, each decoder layer, the final norm, the head) is
drawn from a torch.Generator of its own, seeded from (seed, model tag,
group), in two calls: one for all of its matrices and one for all of its
bias vectors.  So a group can be made again on its own, in the same
numbers, which is how the reference gets its weights back once the
program's are freed.  Matrices are N(0, d_in**-0.5) (embeddings and head
N(0, 0.02)), biases N(0, 0.02), norm weights 1 and norm biases 0; MoE
routers are drawn like matrices, so that every expert gets tokens.
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterator, List, Tuple

import torch

from benchmark.harness import common

Entry = Tuple[str, Tuple[int, ...], str]   # (name, shape, kind)


def moe_layers(cfg: dict) -> Tuple[int, ...]:
    """The decoder layers with experts (LLaVA-MoD's moe_mode)."""
    moe = cfg.get("moe")
    if not moe or not moe.get("num_experts"):
        return ()
    n = cfg["num_hidden_layers"]
    mode = moe["moe_mode"]
    if mode == "sparse":
        return tuple(range(0, n, 2))
    if mode == "dense":
        return tuple(range(n))
    if mode == "first_half":
        return tuple(range(n // 2))
    if mode == "second_half":
        return tuple(range(n // 2, n))
    raise ValueError(f"unknown moe_mode {mode!r}")


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def n_image(cfg: dict) -> int:
    """Feature rows one image gives (the mlp projector keeps the grid)."""
    v = cfg["vision_config"]
    return (v["image_size"] // v["patch_size"]) ** 2


def _ln(prefix: str, d: int) -> List[Entry]:
    return [(f"{prefix}.weight", (d,), "ones"), (f"{prefix}.bias", (d,), "zeros")]


def _dense(prefix: str, din: int, dout: int) -> List[Entry]:
    return [(f"{prefix}.kernel", (din, dout), "dense"),
            (f"{prefix}.bias", (dout,), "bias")]


def groups(cfg: dict, vision: bool = True) -> Dict[str, List[Entry]]:
    """{group: [(name, shape, kind)]} of the whole model, in order: the
    tower (`vision`), the projector, then the decoder's groups."""
    out: Dict[str, List[Entry]] = {}
    v = cfg["vision_config"]
    dv, iv = v["hidden_size"], v["intermediate_size"]
    p = v["patch_size"]
    n_pos = (v["image_size"] // p) ** 2 + 1
    if vision:
        out["vision.stem"] = [
            ("vision.patch_embed.kernel", (p * p * 3, dv), "normal"),
            ("vision.patch_embed.bias", (dv,), "bias"),
            ("vision.pos_embed", (n_pos, dv), "dense"),
            ("vision.class_token", (dv,), "bias"),
        ] + _ln("vision.pre_ln", dv)
        for i in range(v["num_hidden_layers"]):
            pre = f"vision.layers.{i}"
            ent = _ln(pre + ".ln1", dv)
            for n in "qkvo":
                ent += _dense(f"{pre}.attn.{n}", dv, dv)
            ent += _ln(pre + ".ln2", dv)
            ent += _dense(pre + ".mlp.fc1", dv, iv)
            ent += _dense(pre + ".mlp.fc2", iv, dv)
            out[pre] = ent
        out["vision.post_ln"] = _ln("vision.post_ln", dv)
    d = cfg["hidden_size"]
    if cfg["mm_projector_type"] != "mlp2x_gelu":
        raise ValueError("only the mlp2x_gelu projector is laid out here")
    out["projector"] = (_dense("projector.layers.0", dv, d)
                        + _dense("projector.layers.1", d, d))
    out.update(common.architecture(cfg, "harness").groups(cfg))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _std(shape, kind: str) -> float:
    if kind == "dense":
        return shape[-2] ** -0.5 if len(shape) >= 2 else shape[0] ** -0.5
    return 0.02


def _seed(seed: int, tag: str, group: str) -> int:
    return (int(seed) * 1_000_003 + zlib.crc32(f"{tag}/{group}".encode())) \
        % (2 ** 63 - 1)


def make_group(entries: List[Entry], seed: int, tag: str, group: str,
               device, dtype) -> Dict[str, torch.Tensor]:
    """One group's tensors: views of one matrix buffer and one bias
    buffer, each drawn in one call."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, tag, group))
    out: Dict[str, torch.Tensor] = {}
    mats = [x for x in entries if x[2] in ("dense", "normal")]
    vecs = [x for x in entries if x[2] == "bias"]
    for chosen in (mats, vecs):
        total = sum(_numel(s) for _, s, _ in chosen)
        if not total:
            continue
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        at = 0
        for name, shape, kind in chosen:
            n = _numel(shape)
            t = flat[at:at + n].view(shape)
            t.mul_(_std(shape, kind))
            out[name] = t
            at += n
    for name, shape, kind in entries:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
    return out


def iter_groups(cfg: dict, seed: int, tag: str, device, dtype,
                vision: bool = True, only=None
                ) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    for g, entries in groups(cfg, vision).items():
        if only is None or g in only:
            yield g, make_group(entries, seed, tag, g, device, dtype)


@torch.no_grad()
def make_state(cfg: dict, seed: int, tag: str, device, dtype,
               vision: bool = True) -> Dict[str, torch.Tensor]:
    """The whole model's {name: tensor}."""
    state: Dict[str, torch.Tensor] = {}
    for _, g in iter_groups(cfg, seed, tag, device, dtype, vision):
        state.update(g)
    return state
