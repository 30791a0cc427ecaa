"""What the accepted configurations read through the harness, as one
record: their parameter layout (group names, tensor names, shapes, kinds)
and operation and byte counts at full size, and at the tiny sizes of the
CPU tests the seeded tensors (digests of the exact bytes) and the
reference's numbers (sums, which a test compares within rounding).  `parent_snapshot.json` holds the record as the harness
gave it before the decoder's layout moved behind the configuration's
`architecture`; test_bench_arch.py holds today's harness to it.

    python3 benchmark/tests/snapshot.py > benchmark/tests/parent_snapshot.json
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import common, flops  # noqa: E402
from benchmark.harness import weights as wmod  # noqa: E402
from benchmark.reference import checks as rchecks  # noqa: E402
from benchmark.reference import model as rm  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

SEED = 2 ** 31 + 7
CONFIGS = ("llavamod-2b", "llava-qwen1.5-7b")


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().float().contiguous().numpy()
                          .tobytes()).hexdigest()[:24]


def numbers(t: torch.Tensor) -> list:
    """Sums of a float tensor (its values, their magnitudes, every 97th),
    to compare within rounding where a digest would be exact."""
    t = t.detach().double().flatten()
    return [float(t.sum()), float(t.abs().sum()), float(t[::97].sum())]


def layout(cfg: dict) -> dict:
    """Per group, in order: a digest of its (name, shape, kind) entries."""
    return {str(vision): [[g, hashlib.sha256(json.dumps(
        [[n, list(s), k] for n, s, k in ent]).encode()).hexdigest()[:24]]
        for g, ent in wmod.groups(cfg, vision).items()]
        for vision in (True, False)}


def counts(cfg: dict, teacher: dict) -> dict:
    out = {"linear_macs_per_token": list(flops.linear_macs_per_token(cfg)),
           "vision_flops": flops.vision_flops(cfg),
           "head_flops": flops.head_flops(cfg, 3)}
    for n in (1, 577, 1434, 2048):
        out[f"attention_core.{n}"] = flops.attention_core(cfg, n)
        for kind in ("fwd", "bwd", "decode"):
            out[f"attention_work.{n}.{kind}"] = list(
                flops.attention_work(cfg, n, kind))
    for prompt, new in ((700, 1), (700, 4), (1024, 3)):
        out[f"serve_request.{prompt}.{new}"] = flops.serve_request(
            cfg, prompt, new)
    for n in (820, 1434, 2048):
        out[f"distill_microbatch.{n}"] = flops.distill_microbatch(
            cfg, teacher, n)
    return out


def tensors() -> dict:
    out = {}
    for cfg, tag, dtype in ((tiny.STUDENT, "student", torch.float32),
                            (tiny.TEACHER, "teacher", torch.bfloat16),
                            (tiny.STUDENT, "model", torch.bfloat16)):
        state = wmod.make_state(cfg, SEED, tag, "cpu", dtype)
        out[f"{cfg['name']}.{tag}"] = {n: digest(t) for n, t in state.items()}
    return out


def reference() -> dict:
    """The reference decoder, head and loss at the tiny sizes: the
    student (MoE, float) in training and in eval with its router margins,
    in both precisions, and the W8A8 teacher."""
    out = {}
    cfg = tiny.STUDENT
    W = {k: v.float() for k, v in
         wmod.make_state(cfg, SEED, "student", "cpu", torch.float32).items()}
    gen = torch.Generator().manual_seed(SEED)
    t = 57
    emb = torch.randn(t, cfg["hidden_size"], generator=gen)
    ids = torch.randint(0, 1000, (t,), generator=gen)
    rows = torch.randn(4, cfg["hidden_size"], generator=gen)
    labels = ids.clone()
    labels[:9] = -100
    for low in (False, True):
        lin = rm.Linear(W, rm.Numerics(low))
        for train in (True, False):
            margins: list = []
            h, aux = rm.decoder(emb, W, cfg, lin, cap_tokens=t, train=train,
                                margins=margins)
            key = f"student.low={low}.train={train}"
            out[key] = {"hidden": numbers(h), "aux": float(aux),
                        "margins": numbers(torch.stack(margins))}
        e = rm.embed(ids, W, rows, 5)
        h, _ = rm.decoder(e, W, cfg, lin, cap_tokens=t, train=True)
        ls = rm.head(h, W, lin)
        kd, ce = rm.kd_ce(ls, ls.flip(0), labels)
        out[f"student.low={low}.loss"] = {"embed": numbers(e), "logits": numbers(ls),
                                          "kd": float(kd), "ce": float(ce)}
    Wt, quant = rchecks._teacher(tiny.TEACHER, SEED, "cpu")
    lin_t = rm.Linear(Wt, rm.Numerics(), quant)
    emb_t = torch.randn(t, tiny.TEACHER["hidden_size"], generator=gen)
    h, _ = rm.decoder(emb_t, Wt, tiny.TEACHER, lin_t, cap_tokens=t,
                      train=False)
    out["teacher.w8a8"] = {"hidden": numbers(h),
                           "logits": numbers(rm.head(h, Wt, lin_t)),
                           "quantized": sorted(quant)}
    return out


def readings() -> dict:
    """The reference's readings of a tiny first update (two microbatches
    and the one after), as the distillation cells take them."""
    from benchmark.harness import traffic
    from benchmark.harness.tokenizer import StandInTokenizer

    tok = StandInTokenizer()
    mix = dict(tiny.CONVERSATIONS, real_tokens=[240, 300])
    recs = traffic.conversations(mix, SEED, tok, wmod.n_image(tiny.STUDENT))
    imgs = traffic.images(mix, SEED)
    samples = [(r, imgs[i % len(imgs)]) for i, r in enumerate(recs[:3])]
    out = rchecks.train_readings(
        tiny.STUDENT, tiny.TEACHER, SEED, samples[:2], tok, max_len=384,
        cap_tokens=384, lr=2e-5, b1=0.9, b2=0.999, eps=1e-8, clip=1.0,
        aux_coef=0.01, device="cpu", after=samples[2], log=lambda *a: None)
    return {k: v if not isinstance(v, dict) else
            {n: x for n, x in sorted(v.items())} for k, v in out.items()}


def snapshot() -> dict:
    torch.set_num_threads(1)
    cfgs = {n: common.config(n) for n in CONFIGS}
    return {"layout": {n: layout(c) for n, c in cfgs.items()},
            "counts": {n: counts(c, cfgs["llava-qwen1.5-7b"])
                       for n, c in cfgs.items()},
            "tensors": tensors(), "reference": reference(),
            "readings": readings()}


if __name__ == "__main__":
    json.dump(snapshot(), sys.stdout, indent=0, sort_keys=True)
    print()
