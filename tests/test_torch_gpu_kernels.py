"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, in bf16, under the shared elementwise tolerance
(`llavamod_tpu_torch.ops.tolerance`: |a - b| <= 2e-2 + 8e-3 |b|, since the
probabilities are rounded to bf16 before P.V and the outputs are bf16).
Needs a CUDA device and nvcc, so these tests carry the `gpu` marker and skip
elsewhere; run them on the card with

    python -m pytest tests/test_torch_gpu_kernels.py -m gpu
"""

import pytest
import torch

from llavamod_tpu_torch.ops.tolerance import tol_ratio, within_tol

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "for sm_90a and have no CPU mode")
    return torch.device("cuda", 0)


def _seg(lengths, total, dev):
    seg = torch.zeros((len(lengths), total), dtype=torch.int32, device=dev)
    for i, n in enumerate(lengths):
        seg[i, total - n:] = 1
    return seg


def _close(got, want, what):
    assert within_tol(got, want), (what, tol_ratio(got, want))


# name: (B, T, H, KH, D, softcap, causal, valid lengths or None = no segments)
CASES = {
    "t1": (2, 1, 4, 4, 128, None, True, [1, 0]),
    "t63_gqa": (2, 63, 14, 2, 64, None, True, [63, 20]),
    "t130_softcap_noncausal": (2, 130, 4, 4, 128, 30.0, False, [130, 1]),
    "t200_allpad_noncausal": (2, 200, 4, 4, 64, None, False, [200, 0]),
    "t200_gqa_softcap": (2, 200, 14, 2, 128, 50.0, True, [200, 77]),
    "t2048": (1, 2048, 4, 4, 128, None, True, None),
    "t2048_pad": (2, 2048, 2, 2, 128, None, True, [2048, 1500]),
    "t300_d64_noseg": (1, 300, 6, 3, 64, None, False, None),
}


def _inputs(case, dev, seed, fused=False):
    b, t, h, kh, d, cap, causal, lengths = CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    if fused:   # q/k/v as strided views of one [B, T, 3, H, D] tensor
        assert h == kh
        qkv = torch.randn((b, t, 3, h, d), generator=g, device=dev).bfloat16()
        q, k, v = qkv.unbind(2)
    else:
        q = torch.randn((b, t, h, d), generator=g, device=dev).bfloat16()
        k = torch.randn((b, t, kh, d), generator=g, device=dev).bfloat16()
        v = torch.randn((b, t, kh, d), generator=g, device=dev).bfloat16()
    do = torch.randn((b, t, h, d), generator=g, device=dev).bfloat16()
    seg = _seg(lengths, t, dev) if lengths is not None else None
    real = seg.bool() if seg is not None else torch.ones(
        (b, t), dtype=torch.bool, device=dev)
    return q, k, v, do, seg, real, dict(causal=causal, softcap=cap)


def _check_fwd(q, k, v, seg, real, kw):
    from llavamod_tpu_torch.ops.flash_attention import (
        flash_fwd,
        flash_fwd_reference,
    )

    n0 = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, seg, seg, **kw)
    assert flash_fwd.launches == n0 + 1
    o_ref, lse_ref = flash_fwd_reference(q, k, v, seg, seg, **kw)
    _close(o[real], o_ref[real], "o")
    _close(lse.permute(0, 2, 1)[real], lse_ref.permute(0, 2, 1)[real], "lse")
    assert (o[~real] == 0).all()
    assert (lse.permute(0, 2, 1)[~real] == -1e30).all()
    return o, lse


def _check_bwd(q, k, v, o, lse, do, seg, real, kw):
    from llavamod_tpu_torch.ops.flash_attention import (
        flash_bwd,
        flash_bwd_reference,
        flash_dkv,
        flash_dq,
    )

    n0 = (flash_dq.launches, flash_dkv.launches)
    got = flash_bwd(q, k, v, o, lse, do, seg, seg, **kw)
    assert (flash_dq.launches, flash_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    want = flash_bwd_reference(q, k, v, o, lse, do, seg, seg, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, name)
        assert (a[~real] == 0).all(), name          # pad rows and keys: 0


@pytest.mark.parametrize("case", ["t1", "t63_gqa", "t130_softcap_noncausal",
                                  "t200_gqa_softcap", "t2048_pad",
                                  "t300_d64_noseg"])
def test_flash_fwd_kernel_matches_plain(dev, case):
    q, k, v, _, seg, real, kw = _inputs(case, dev, 0)
    _check_fwd(q, k, v, seg, real, kw)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_bwd_kernels_match_plain(dev, case):
    q, k, v, do, seg, real, kw = _inputs(case, dev, 2)
    o, lse = _check_fwd(q, k, v, seg, real, kw)
    _check_bwd(q, k, v, o, lse, do, seg, real, kw)


@pytest.mark.parametrize("case", ["t130_softcap_noncausal", "t2048_pad"])
def test_kernels_take_strided_views_of_a_fused_qkv(dev, case):
    q, k, v, do, seg, real, kw = _inputs(case, dev, 3, fused=True)
    assert not q.is_contiguous()
    o, lse = _check_fwd(q, k, v, seg, real, kw)
    _check_bwd(q, k, v, o, lse, do, seg, real, kw)


def _bwd_args(case, dev, seed):
    from llavamod_tpu_torch.ops.flash_attention import flash_fwd

    q, k, v, do, seg, _, kw = _inputs(case, dev, seed)
    o, lse = flash_fwd(q, k, v, seg, seg, **kw)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    return (q, k, v, do, lse, delta, seg, seg), kw


def test_flash_dkv_is_deterministic(dev):
    from llavamod_tpu_torch.ops.flash_attention import flash_dkv

    args, kw = _bwd_args("t2048", dev, 4)
    dk1, dv1 = flash_dkv(*args, **kw)
    dk2, dv2 = flash_dkv(*args, **kw)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.parametrize("case", ["t2048", "t200_gqa_softcap"])
def test_flash_dq_is_deterministic(dev, case):
    from llavamod_tpu_torch.ops.flash_attention import flash_dq

    args, kw = _bwd_args(case, dev, 5)
    assert torch.equal(flash_dq(*args, **kw), flash_dq(*args, **kw))


# the split decode's edges: name: (B, H, KH, D, S)
DECODE_CASES = {
    "serve_b8": (8, 16, 16, 128, 1056),
    "serve_b1": (1, 16, 16, 128, 1056),
    "s1": (1, 16, 16, 128, 1),
    "s127": (2, 4, 4, 64, 127),
    "s128": (1, 16, 16, 128, 128),
    "s129": (4, 8, 8, 128, 129),
    "s4200_g8": (4, 16, 2, 128, 4200),
    "s300_g7": (3, 7, 1, 64, 300),
}
ROW_KINDS = ("pad", "one_split", "single", "none")


def _decode_seg(b, kh, s, dev, first):
    """Row i takes the kind ROW_KINDS[(k0 + i) % 4] (k0 = the index of
    `first`): left padding with the last slot not yet written, live slots
    inside the last split only, one live slot, or none."""
    from llavamod_tpu_torch.ops.decode_attention import (
        decode_splits,
        split_bounds,
    )

    splits = decode_splits(
        b, kh, s, torch.cuda.get_device_properties(dev).multi_processor_count)
    lo, hi = split_bounds(s, splits, splits - 1)
    seg = torch.zeros((b, s), dtype=torch.int32)
    k0 = ROW_KINDS.index(first)
    for i in range(b):
        kind = ROW_KINDS[(k0 + i) % 4]
        if kind == "pad":
            seg[i, s // 3:max(s - 1, 1)] = 1
        elif kind == "one_split":
            seg[i, lo + (hi - lo) // 4:hi] = 1
        elif kind == "single":
            seg[i, (7 * s) // 11] = 1
    return seg.to(dev)


def _decode_inputs(case, dtype, dev, first="pad"):
    from llavamod_tpu_torch.models.llm.decoder import _quantize_kv

    b, h, kh, d, s = DECODE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, kh, s, d), generator=g, device=dev)
    v = torch.randn((b, kh, s, d), generator=g, device=dev)
    kw = {}
    if dtype == "int8":
        k, ks = _quantize_kv(k)
        v, vs = _quantize_kv(v)
        kw = dict(k_scale=ks, v_scale=vs)
    elif dtype == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    return q, k, v, _decode_seg(b, kh, s, dev, first), kw


def _check_decode(q, k, v, seg, kw):
    from llavamod_tpu_torch.ops.decode_attention import (
        flash_decode,
        flash_decode_reference,
    )

    n0, i0 = flash_decode.launches, flash_decode.int8_launches
    out = flash_decode(q, k, v, kv_seg=seg, **kw)
    assert flash_decode.launches == n0 + 1
    assert flash_decode.int8_launches == i0 + (k.dtype == torch.int8)
    ref = flash_decode_reference(q, k, v, kv_seg=seg, **kw)
    _close(out, ref, "decode")
    dead = ~(seg != 0).any(dim=1)                   # rows with no live slot
    assert (out[dead] == 0).all()
    return out


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_flash_decode_split_edges(dev, case, dtype):
    _check_decode(*_decode_inputs(case, dtype, dev))


@pytest.mark.parametrize("first", ROW_KINDS)
def test_flash_decode_b1_row_kinds(dev, first):
    _check_decode(*_decode_inputs("serve_b1", "bf16", dev, first))


def test_flash_decode_is_deterministic(dev):
    from llavamod_tpu_torch.ops.decode_attention import flash_decode

    q, k, v, seg, kw = _decode_inputs("serve_b8", "bf16", dev)
    assert torch.equal(flash_decode(q, k, v, kv_seg=seg, **kw),
                       flash_decode(q, k, v, kv_seg=seg, **kw))


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("h,kh,d", [(4, 4, 128), (8, 1, 64)])
def test_flash_decode_kernel_matches_plain(dev, dtype, h, kh, d):
    from llavamod_tpu_torch.models.llm.decoder import _quantize_kv
    from llavamod_tpu_torch.ops.decode_attention import (
        flash_decode,
        flash_decode_reference,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    s = 300
    q = torch.randn((3, h, d), generator=g, device=dev).bfloat16()
    k = torch.randn((3, kh, s, d), generator=g, device=dev)
    v = torch.randn((3, kh, s, d), generator=g, device=dev)
    seg = _seg([290, 200, 7], s, dev)
    kw = {}
    if dtype == "int8":
        k, ks = _quantize_kv(k)
        v, vs = _quantize_kv(v)
        kw = dict(k_scale=ks, v_scale=vs)
    elif dtype == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    n0 = flash_decode.launches
    out = flash_decode(q, k, v, kv_seg=seg, **kw)
    assert flash_decode.launches == n0 + 1
    ref = flash_decode_reference(q, k, v, kv_seg=seg, **kw)
    _close(out, ref, "decode")


def test_kernels_build_without_spills(dev):
    """ptxas -v of every kernel (the log kept beside the built library)
    reports no register spill and no serialised wgmma."""
    from pathlib import Path

    from llavamod_tpu_torch.ops import cuda_build

    cuda_build.load_library()
    log = Path(cuda_build.build_info["path"]).with_suffix(".log").read_text()
    stats = [ln.strip() for ln in log.splitlines() if "spill" in ln]
    assert stats, "no ptxas -v lines in the build log"
    assert all(ln.endswith("0 bytes spill stores, 0 bytes spill loads")
               and ln.startswith("0 bytes stack frame") for ln in stats), stats
    assert "C7512" not in log                     # wgmma serialised


def test_kernels_refuse_what_they_do_not_take(dev):
    from llavamod_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_dkv,
        flash_dq,
    )

    x = torch.zeros((1, 8, 2, 32), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(x, x, x, causal=True)           # head_dim 32
    y = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(y, y, y, causal=True)           # fp16
    # a gradient through flash attention on the card runs K3 and K4
    z = torch.randn((1, 8, 2, 64), device=dev).bfloat16().requires_grad_()
    n0 = (flash_dq.launches, flash_dkv.launches)
    flash_attention(z, z, z, causal=True).float().sum().backward()
    assert (flash_dq.launches, flash_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    assert torch.isfinite(z.grad.float()).all()
    w = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float32,
                    requires_grad=True)
    with pytest.raises(TypeError):
        flash_attention(w, w, w, causal=True)           # f32


# int8 W8A8 products on the card (llavamod_tpu_torch/ops/int8.py): the
# library's int8 GEMM, exact, so bitwise equal to the f64 product.
INT8_SHAPES = {   # name: (M, K, N)
    "decode_b8_padded": (8, 4096, 12288),
    "one_row_padded": (1, 2048, 5504),
    "rows_17": (17, 4096, 12288),
    "odd_rows": (1001, 2048, 5504),
    "teacher_down": (2048, 11008, 4096),
}


@pytest.mark.parametrize("layout", ["k_major", "n_major"])
@pytest.mark.parametrize("case", list(INT8_SHAPES))
def test_int8_matmul_is_exact_on_the_card(dev, case, layout):
    from llavamod_tpu_torch.ops.int8 import int8_matmul

    m, k, n = INT8_SHAPES[case]
    g = torch.Generator(device=dev).manual_seed(m + k + n)

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    a = ri(m, k)
    b = ri(n, k).t() if layout == "k_major" else ri(k, n)
    y = int8_matmul(a, b)
    assert y.dtype == torch.int32 and y.shape == (m, n)
    assert torch.equal(y.double(), a.double() @ b.double())


def test_int8_matmul_refuses_widths_the_library_refuses(dev):
    from llavamod_tpu_torch.ops.int8 import int8_matmul

    a = torch.zeros((32, 60), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        int8_matmul(a, torch.zeros((60, 64), dtype=torch.int8, device=dev))


def test_int8_dense_on_the_card_matches_the_cpu(dev):
    """The W8A8 dense, forward and straight-through dx, on the card equals
    the same function on the CPU: the int8 products are exact on both, the
    f32 rescale is elementwise."""
    from llavamod_tpu_torch.models.llm import decoder as tdec

    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 8, 2048), generator=g)
    w = tdec.quantize_dense_int8(torch.randn((2048, 4096), generator=g))
    gy = torch.randn((4, 8, 4096), generator=g)
    outs = []
    for d in ("cpu", dev):
        wd = tdec.Int8Weight(w.w_int8.to(d), w.scale.to(d))
        xd = x.detach().to(d).requires_grad_()
        y = tdec.dense(xd, wd)
        y.backward(gy.to(d))
        outs.append((y.detach().cpu(), xd.grad.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
