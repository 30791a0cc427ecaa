"""The operation and byte counts against hand counts at two shapes."""

import pytest

from benchmark.harness import common, flops

S = common.config("llavamod-2b")
T = common.config("llava-qwen1.5-7b")


def test_linear_macs_by_hand():
    # Qwen1.5-1.8B: 4 d^2 attention projections, 12 dense FFN layers of
    # 3 d f, 12 MoE layers with 2 of 4 experts and a router
    attn, ffn = flops.linear_macs_per_token(S)
    assert attn == 24 * 4 * 2048 * 2048
    assert ffn == 12 * 3 * 2048 * 5504 + 12 * (2 * 3 * 2048 * 5504 + 2048 * 4)
    attn, ffn = flops.linear_macs_per_token(T)
    assert attn == 32 * 4 * 4096 ** 2 and ffn == 32 * 3 * 4096 * 11008


@pytest.mark.parametrize("n", [1, 1000])
def test_attention_core_by_hand(n):
    assert flops.attention_core(S, n) == 24 * 16 * 128 * 4 * n * (n + 1) / 2


def test_attention_work_by_hand():
    f, b = flops.attention_work(S, 1024, "fwd")
    assert f == 4 * 2048 * 1024 * 1025 / 2
    assert b == 2 * 1024 * 128 * 64
    f, b = flops.attention_work(T, 1000, "decode")
    assert f == 4 * 4096 * 1000 and b == 2 * (2 * 1000 * 4096 + 2 * 4096)
    f2, b2 = flops.attention_work(S, 1024, "bwd")
    assert f2 == 2 * flops.attention_work(S, 1024, "fwd")[0]
    assert b2 == 2 * 1024 * 128 * 128


def test_roofline_takes_the_larger_bound():
    assert flops.roofline_seconds(flops.PEAK_BF16, 0) == 1.0
    assert flops.roofline_seconds(0, flops.HBM_BYTES_PER_S) == 1.0


def test_vision_by_hand():
    # 23 of CLIP-L's 24 blocks on 577 tokens, the patch product, the
    # mlp2x_gelu projector to 2048
    n, d, f = 577, 1024, 4096
    block = 2 * n * (4 * d * d + 2 * d * f) + 4 * n * n * d
    proj = 2 * 576 * (1024 * 2048 + 2048 * 2048)
    assert flops.vision_flops(S) == 2 * 576 * 588 * 1024 + 23 * block + proj


def test_distill_counts_split_by_precision():
    out = flops.distill_microbatch(S, T, 1400)
    a, f = flops.linear_macs_per_token(T)
    assert out["int8"] == 2 * 1400 * (a + f) + 2 * 1400 * 4096 * 151936 \
        + 2 * 1400 * 2048 * 151936
    assert flops.least_seconds(out) == pytest.approx(
        out["bf16"] / 989e12 + out["int8"] / 1979e12)


def test_serve_request_counts_decode_steps():
    one = flops.serve_request(S, 700, 1)["bf16"]
    two = flops.serve_request(S, 700, 2)["bf16"]
    a, f = flops.linear_macs_per_token(S)
    assert two - one == 2 * (a + f) + 2 * 2048 * 151936 + 24 * 4 * 2048 * 701
