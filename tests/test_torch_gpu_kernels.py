"""The hand-written CUDA kernels against their plain PyTorch versions on the
card (bf16, tolerance 2e-2: probabilities are rounded to bf16 before P.V
and the outputs are bf16).  Needs a CUDA device and nvcc, so these tests
carry the `gpu` marker and skip elsewhere; run them on the card with

    python -m pytest tests/test_torch_gpu_kernels.py -m gpu
"""

import pytest
import torch

pytestmark = pytest.mark.gpu
TOL = 2e-2


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


@pytest.mark.parametrize("h,kh,d,softcap,t", [
    (4, 4, 128, None, 200), (6, 2, 64, None, 130), (4, 4, 128, 30.0, 64)])
def test_flash_fwd_kernel_matches_plain(dev, h, kh, d, softcap, t):
    from llavamod_tpu_torch.ops.flash_attention import (
        flash_fwd,
        flash_fwd_reference,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, t, h, d), generator=g, device=dev).bfloat16()
    k = torch.randn((2, t, kh, d), generator=g, device=dev).bfloat16()
    v = torch.randn((2, t, kh, d), generator=g, device=dev).bfloat16()
    seg = _seg([t, t // 3], t, dev)
    n0 = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, seg, seg, causal=True, softcap=softcap)
    assert flash_fwd.launches == n0 + 1
    o_ref, lse_ref = flash_fwd_reference(q, k, v, seg, seg, causal=True,
                                         softcap=softcap)
    real = seg.bool()
    assert (o.float() - o_ref.float()).abs()[real].max().item() <= TOL
    assert (lse - lse_ref).abs().permute(0, 2, 1)[real].max().item() <= TOL
    assert (o[~real] == 0).all()


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
    assert (out.float() - ref.float()).abs().max().item() <= TOL


@pytest.mark.parametrize("h,kh,d,softcap,t,causal", [
    (4, 4, 128, None, 200, True), (6, 2, 64, None, 130, True),
    (4, 2, 128, 30.0, 64, False), (14, 2, 64, 50.0, 300, True)])
def test_flash_bwd_kernels_match_plain(dev, h, kh, d, softcap, t, causal):
    from llavamod_tpu_torch.ops.flash_attention import (
        flash_bwd,
        flash_bwd_reference,
        flash_dkv,
        flash_dq,
        flash_fwd,
    )

    g = torch.Generator(device=dev).manual_seed(2)
    q, do = (torch.randn((2, t, h, d), generator=g, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((2, t, kh, d), generator=g, device=dev).bfloat16()
            for _ in range(2))
    seg = _seg([t, t // 3], t, dev)
    o, lse = flash_fwd(q, k, v, seg, seg, causal=causal, softcap=softcap)
    n0 = (flash_dq.launches, flash_dkv.launches)
    got = flash_bwd(q, k, v, o, lse, do, seg, seg, causal=causal,
                    softcap=softcap)
    assert (flash_dq.launches, flash_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    want = flash_bwd_reference(q, k, v, o, lse, do, seg, seg, causal=causal,
                               softcap=softcap)
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max().item() <= TOL
    real = seg.bool()
    assert (got[0][~real] == 0).all()                   # pad rows: dq 0
    assert (got[1][~real] == 0).all() and (got[2][~real] == 0).all()


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
