"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and nvcc; without one they skip. On a machine
with a card and no JAX, run them without the repository's conftest (which
imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Shapes are small but ragged (row, query and key counts that are not tile
multiples). Inputs are bf16 from a seeded torch.Generator. Tolerance: a few
bf16 ulps of the largest reference value, because kernel and plain version
round at the same points but sum in another order, which can flip a rounding.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * std
            + mean).to(dtype)


def _counts(**launches):
    """Expected launch counts: the named counters, every other one 0."""
    from mtt_tpu_torch.kernels import _build
    return {**dict.fromkeys(_build.COUNTS, 0), **launches}


def _check(got, want, ulps=4):
    """``ulps``: bf16 ulps of the largest reference value, one number or one
    per output."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    per_out = ulps if isinstance(ulps, tuple) else (ulps,) * len(got)
    torch.cuda.synchronize()
    for g, w, u in zip(got, want, per_out):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g).all()
        tol = u * w.float().abs().max().item() * 2.0 ** -7
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol, (err, tol)


# ragged shapes, then the Swin-B stage widths over a few thousand rows
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 37, 1024), (5, 64), (2, 9, 1536),
                                   (2, 5, 7, 2880), (3, 11, 4096),
                                   (2, 3, 4, 4, 144), (3001, 128),
                                   (2999, 256), (2049, 512), (1025, 1024),
                                   (7, 8), (13, 40)])
def test_layernorm_kernel(gen, shape, param_dtype):
    """Parameters in f32 or bf16: read in their dtype, no cast launched."""
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    C = shape[-1]
    x = _rnd(gen, *shape)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=param_dtype)
    b = _rnd(gen, C, std=0.1, dtype=param_dtype)
    _check(fused_layernorm(x, g, b), fused_layernorm(x, g, b, impl="plain"),
           ulps=1)


# token counts around the attention core's 64-key tile, the 128-key tile of
# its max pass and its 128-row block, and ViT-L's 1029
RAGGED_N = [1, 15, 63, 64, 65, 77, 127, 128, 129, 1029]


@pytest.mark.parametrize("need_qkv", [False, True])
@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("N", RAGGED_N)
def test_attention_kernels(gen, need_qkv, safe, N):
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
    B, H, D = 2, 4, 64
    C = H * D
    x = _rnd(gen, B, N, C)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=torch.float32)
    b = _rnd(gen, C, std=0.1, dtype=torch.float32)
    w = _rnd(gen, 3 * C, C, std=C ** -0.5)
    bq = _rnd(gen, 3 * C, std=0.1)
    args = (x, g, b, w, bq, H)
    _check(fused_attention_ln_qkv(*args, need_qkv=need_qkv, safe=safe),
           fused_attention_ln_qkv(*args, need_qkv=need_qkv, safe=safe,
                                  impl="plain"))


# the five widths with their hidden sizes, and a hidden that is not a
# multiple of the GEMMs' 64-wide K stage
MLP_WIDTHS = [(1024, 4096), (768, 3072), (576, 2304), (288, 1152), (144, 576),
              (1024, 1040)]


def _mlp_args(gen, rows, C, Hd, param_dtype=torch.float32):
    x = _rnd(gen, rows, C)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=param_dtype)
    b = _rnd(gen, C, std=0.1, dtype=param_dtype)
    w1, b1 = _rnd(gen, Hd, C, std=C ** -0.5), _rnd(gen, Hd, std=0.1)
    w2, b2 = _rnd(gen, C, Hd, std=Hd ** -0.5), _rnd(gen, C, std=0.1)
    return x, g, b, w1, b1, w2, b2


# rows around the GEMMs' 128-row tile, and ViT-L's 8 x 1029
@pytest.mark.parametrize("rows", [1, 127, 128, 129, 8232])
@pytest.mark.parametrize("C,Hd", MLP_WIDTHS)
def test_mlp_kernel(gen, C, Hd, rows):
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res
    args = _mlp_args(gen, rows, C, Hd)
    _check(fused_mlp_ln_res(*args), fused_mlp_ln_res(*args, impl="plain"))


def test_mlp_kernel_bf16_params_and_repeat_bits(gen):
    """LN and bias parameters in bf16 (read as stored), and two runs give
    equal bits (no split-K, no atomics)."""
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res
    args = _mlp_args(gen, 1029, 1024, 4096, torch.bfloat16)
    got = fused_mlp_ln_res(*args)
    _check(got, fused_mlp_ln_res(*args, impl="plain"))
    assert torch.equal(got, fused_mlp_ln_res(*args))


def test_mlp_kernel_refuses_unaligned_views(gen):
    """TMA reads 16-byte aligned data only: a view two bytes into its
    storage raises and does not fall back."""
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res
    x, *rest = _mlp_args(gen, 64, 768, 3072)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    xv = buf[1:].view_as(x)
    xv.copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        fused_mlp_ln_res(xv, *rest)


def _decode_args(gen, B, S, C, T, G, tar, fin, cw_dtype=torch.float32,
                 bias_dtype=torch.bfloat16, a_dtype=torch.bfloat16):
    return (_rnd(gen, B, S, C), _rnd(gen, B, T, S, G, dtype=a_dtype),
            _rnd(gen, B, T, C, dtype=cw_dtype),
            _rnd(gen, T, tar, C, std=C ** -0.5),
            _rnd(gen, T, tar, std=0.1, dtype=bias_dtype),
            _rnd(gen, T, tar, C, std=C ** -0.5),
            _rnd(gen, T, tar, std=0.1, dtype=bias_dtype),
            _rnd(gen, T, fin, 2 * tar, std=(2 * tar) ** -0.5),
            _rnd(gen, T, fin, std=0.1, dtype=bias_dtype))


@pytest.mark.parametrize("S,tar,fin", [(50, 300, 350), (64, 16, 40)])
def test_task_decode_kernel(gen, S, tar, fin):
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode
    args = _decode_args(gen, 2, S, 256, 3, 4, tar, fin)
    _check(fused_task_decode(*args), fused_task_decode(*args, impl="plain"))


# the main path's (8, 1024, 1024), ViT-B's C = 768, ragged row counts (one
# short of and one past the 64-row tile, and a lone row) and K past its last
# 64-wide chunk (C = 200); a, cw and the biases in either dtype
@pytest.mark.parametrize("B,S,C,G,dts", [
    (8, 1024, 1024, 16, ("bf16", "f32", "bf16")),
    (8, 1024, 768, 16, ("bf16", "f32", "bf16")),
    (2, 63, 768, 16, ("f32", "bf16", "f32")),
    (3, 65, 1024, 16, ("bf16", "bf16", "f32")),
    (1, 1, 256, 4, ("f32", "f32", "bf16")),
    (2, 77, 200, 25, ("bf16", "f32", "bf16"))])
def test_task_decode_kernel_shapes_and_repeat_bits(gen, B, S, C, G, dts):
    """Within 4 ulps of the plain version, and two runs give equal bits (no
    split-K, no atomics)."""
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    args = _decode_args(gen, B, S, C, 5, G, 300, 350, a_dtype=dt[dts[0]],
                        cw_dtype=dt[dts[1]], bias_dtype=dt[dts[2]])
    got = fused_task_decode(*args)
    _check(got, fused_task_decode(*args, impl="plain"))
    assert torch.equal(got, fused_task_decode(*args))


def test_task_decode_kernel_refuses_unaligned_views(gen):
    """TMA reads 16-byte aligned data only: an x two bytes into its storage
    raises and does not fall back."""
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode
    x, *rest = _decode_args(gen, 2, 64, 256, 3, 4, 16, 40)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    xv = buf[1:].view_as(x)
    xv.copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        fused_task_decode(xv, *rest)


def test_model_goes_through_kernels(gen):
    """TaskPrompter-ViT-B (C=768, D=64) at 64x64 in bf16: every kernel of
    the path launches, and the logits' relative RMS error against an f32 run
    of the same weights stays within 0.1 (bf16 rounding through random
    weights; a wiring fault gives errors of order 1; as in chip_smoke.py)."""
    import copy

    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet

    tasks = ("semseg", "edge")
    model = TaskPrompterNet(tasks, {"semseg": 21, "edge": 1}, (64, 64),
                            "TaskPrompter_vitB", head_up4="dense",
                            device="cuda", dtype=torch.bfloat16).eval()
    init_weights(model, gen)
    x = torch.randn(2, 64, 64, 3, generator=gen, device="cuda")
    _build.reset_counts()
    logits, preds = predict(model, x)
    torch.cuda.synchronize()
    # 64x64 is a 4x4 grid, which the up4 head kernel does not take: the
    # dense head keeps this forward on the kernels
    assert _build.COUNTS == _counts(layernorm=4 + 1, attention_cached=8,
                                    attention_emit=4, mlp_ln_res=12,
                                    task_decode=4)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref, _ = predict(copy.deepcopy(model).float(), x, impl="plain")
    for t in tasks:
        assert logits[t].shape == ref[t].shape
        assert preds[t].shape == (2, 64, 64)
        r = ref[t].float()
        err = ((logits[t].float() - r).norm() / r.norm()).item()
        assert err <= 0.1, (t, err)


@pytest.mark.parametrize("gh,gw,n,C", [
    (32, 32, 1, 350), (32, 32, 21, 350), (28, 36, 21, 350), (28, 36, 1, 768),
    (28, 36, 3, 768), (28, 36, 40, 768), (8, 12, 5, 528)])
def test_head_up4_kernel(gen, gh, gw, n, C):
    """Main-path grid with the smallest and largest n, NYUD's 28x36, and
    NYUD's C = 768 with its n (depth and edge, normals, semseg), where the
    mix kernel walks slabs of channels (C = 528 ends in a partial one)."""
    from mtt_tpu_torch.kernels.head_up4 import fused_up4_head
    args = _head_args(gen, 2, gh, gw, C, n)
    _check(fused_up4_head(*args), fused_up4_head(*args, impl="plain"))


def _head_args(gen, B, gh, gw, C, n):
    return (_rnd(gen, B, gh, gw, C, std=0.3),
            _rnd(gen, 3, 3, C, C, std=(9 * C) ** -0.5),
            _rnd(gen, C, std=0.1, mean=1.0, dtype=torch.float32),
            _rnd(gen, C, std=0.1, dtype=torch.float32),
            _rnd(gen, C, n, std=C ** -0.5))


# n = 128 (every logit in one pass); grids whose row ranges end short (28 or
# 36 rows over few strips) and a lone strip (gw = 8, one image); NYUD's 28x36
# at C = 768 with n = 40 (four slabs); D not a multiple of the 64-channel
# step (C = 200)
@pytest.mark.parametrize("B,gh,gw,C,n", [
    (2, 8, 8, 48, 128), (2, 12, 8, 350, 128), (8, 28, 8, 48, 5),
    (1, 36, 8, 64, 3), (8, 28, 36, 768, 40), (2, 16, 12, 200, 21)])
def test_head_up4_kernel_shapes_and_repeat_bits(gen, B, gh, gw, C, n):
    """Within 4 ulps of the plain version, and two runs give equal bits (the
    later slabs' logits are added to the first's in a fixed order)."""
    from mtt_tpu_torch.kernels.head_up4 import fused_up4_head
    args = _head_args(gen, B, gh, gw, C, n)
    got = fused_up4_head(*args)
    _check(got, fused_up4_head(*args, impl="plain"))
    assert torch.equal(got, fused_up4_head(*args))


def test_head_up4_kernel_refuses_unaligned_views(gen):
    """The Gm launch reads x with TMA, 16-byte aligned data only: an x two
    bytes into its storage raises and does not fall back (C % 8 == 0, so the
    wrapper copies nothing)."""
    from mtt_tpu_torch.kernels.head_up4 import fused_up4_head
    x, *rest = _head_args(gen, 1, 8, 8, 64, 5)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    xv = buf[1:].view_as(x)
    xv.copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        fused_up4_head(xv, *rest)


@pytest.mark.parametrize("N,H", [(1, 4), (16, 4), (64, 4), (65, 4), (77, 4),
                                 (1029, 16)])
def test_attention_bwd_kernel(gen, N, H):
    """dq, dk and dv each within 4 bf16 ulps of their own largest value: one
    key, a part tile, one 64-row tile, one row past it, the ragged N and the
    ViT-L training shape (16 heads of 1029 tokens)."""
    from mtt_tpu_torch.kernels.attention import (attn_core_bwd_cuda,
                                                 attn_core_bwd_plain)
    B, D = 2, 64
    qkv = _rnd(gen, B, N, H * 3 * D)
    g = _rnd(gen, B, N, H * D)
    got = attn_core_bwd_cuda(qkv, g, H, D ** -0.5).view(B, N, H, 3, D)
    want = attn_core_bwd_plain(qkv, g, H, D ** -0.5).view(B, N, H, 3, D)
    _check(tuple(got[:, :, :, i] for i in range(3)),
           tuple(want[:, :, :, i] for i in range(3)))


@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("N", RAGGED_N)
def test_attention_qkv_kernel(gen, N, safe):
    """Row 13 on the card: the attention core kernel launched under its own
    count, against its plain version."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.attention import fused_attention_qkv
    B, H, D = 2, 4, 64
    qkv = _rnd(gen, B, N, H * 3 * D)
    _build.reset_counts()
    got = fused_attention_qkv(qkv, H, safe=safe)
    assert _build.COUNTS == _counts(attention_qkv=1)
    _check(got, fused_attention_qkv(qkv, H, safe=safe, impl="plain"))


def _leaning_attention_core(gen, entry, N, lean=0.3):
    """A call ``run(impl, safe)`` of one entry point that reaches the
    attention core, ``qkv`` (row 13, ``fused_attention_qkv``), ``cached`` or
    ``emit`` (rows 1 and 2, ``fused_attention_ln_qkv``), on seeded inputs of
    B 2, 4 heads of 64; and the packed qkv the card's kernels hand to the core
    (the front halves': their LN and projection kernels' output). ``lean``
    mixes each key toward its own query (k = lean q + sqrt(1 - lean^2) k'),
    so that each row's max tends to lie at its own key: past the first 64-key
    tile for every row from 64 on."""
    from mtt_tpu_torch.kernels.attention import (fused_attention_ln_qkv,
                                                 fused_attention_qkv,
                                                 qkv_proj_cuda)
    from mtt_tpu_torch.kernels.layernorm import layernorm_cuda
    B, H, D = 2, 4, 64
    C = H * D
    mix = (1.0 - lean * lean) ** 0.5
    if entry == "qkv":
        qkv = _rnd(gen, B, N, H * 3 * D)
        v5 = qkv.view(B, N, H, 3, D)
        v5[:, :, :, 1] = (lean * v5[:, :, :, 0].float()
                          + mix * v5[:, :, :, 1].float()).to(qkv.dtype)
        return (lambda impl, safe: fused_attention_qkv(qkv, H, impl=impl,
                                                       safe=safe)), qkv
    x = _rnd(gen, B, N, C)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=torch.float32)
    b = _rnd(gen, C, std=0.1, dtype=torch.float32)
    w = _rnd(gen, 3 * C, C, std=C ** -0.5)
    bq = _rnd(gen, 3 * C, std=0.1)
    w5, b5 = w.view(H, 3, D, C), bq.view(H, 3, D)
    w5[:, 1] = (lean * w5[:, 0].float() + mix * w5[:, 1].float()).to(w.dtype)
    b5[:, 1] = (lean * b5[:, 0].float() + mix * b5[:, 1].float()).to(w.dtype)
    return (lambda impl, safe: fused_attention_ln_qkv(
        x, g, b, w, bq, H, need_qkv=entry == "emit", impl=impl, safe=safe)), \
        qkv_proj_cuda(layernorm_cuda(x, g, b, 1e-6), w, bq)


def _bit_share(got, want) -> float:
    return (got.view(torch.int16) == want.view(torch.int16)).float().mean(
        ).item()


@pytest.mark.parametrize("entry", ["qkv", "cached", "emit"])
@pytest.mark.parametrize("N", [77, 129, 1029])
def test_attention_safe_softmax_takes_the_max_over_all_keys(gen, entry, N):
    """The safe softmax of rows 1, 2 and 13 subtracts the max over ALL keys
    before it rounds P to bf16, as the TPU kernels do: at least 99% of the
    outputs are bit-equal to the plain version, with each row's max in a
    late key tile (keys leaning toward their own query). A kernel that
    rounds P against a running (online) max instead falls well short of
    that; the 4-ulp bound alone cannot see the difference. The front
    halves are held to 4 ulps of their plain version, and their core to the
    share against the plain core on the qkv their own kernels made (LN and
    projection roundings that differ move more bits than the softmax)."""
    from mtt_tpu_torch.kernels.attention import attention_qkv_plain
    run, qkv = _leaning_attention_core(gen, entry, N)
    got = run("cuda", True)
    _check(got, run("plain", True))
    out = got[0] if entry == "emit" else got
    share = _bit_share(out, attention_qkv_plain(qkv, 4, 0.125, safe=True))
    assert share >= 0.99, share


@pytest.mark.parametrize("Nq,Nk,H,D", [
    (77, 77, 4, 64), (1029, 1029, 2, 64), (130, 37, 2, 72), (64, 200, 3, 32),
    (50, 65, 2, 128), (33, 16, 2, 8), (20, 300, 1, 80),
    (9, 1, 2, 64), (1, 7, 2, 72), (1, 1, 1, 8), (129, 63, 2, 64),
    (127, 65, 2, 64), (65, 127, 2, 128), (40, 129, 2, 72), (70, 128, 2, 8),
    (257, 320, 2, 72), (100, 1029, 2, 128)])
def test_attention_generic_kernel(gen, Nq, Nk, H, D):
    """Row 14 on the card against its plain version: self and cross
    attention, ragged query and key counts, every head-dim tile (32, 64, 80,
    128) and a head dim that is not a multiple of 16; logits wide enough
    that the max subtraction matters. The edges of the tiling: one key,
    fewer keys than an mma tile (16), one query, key counts one short of and
    one past the 64-key tile and the 128-key tile of the max pass, query
    counts one past and one short of the 128-row block (head dims up to 64)
    and the 64-row block (72 and 128)."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.attention import fused_attention
    q = _rnd(gen, 2, Nq, H, D, std=2.0)
    k = _rnd(gen, 2, Nk, H, D, std=2.0)
    v = _rnd(gen, 2, Nk, H, D)
    _build.reset_counts()
    got = fused_attention(q, k, v)
    assert _build.COUNTS == _counts(attention_generic=1)
    _check(got, fused_attention(q, k, v, impl="plain"))


@pytest.mark.parametrize("kernel", ["attention_generic",
                                    "attention_generic@cross",
                                    "attention_bwd", "attention_qkv",
                                    "attention_qkv_safe",
                                    "window_attention_bwd"])
def test_attention_kernels_repeat_bits(gen, kernel):
    """Two launches on the same inputs give the same bits: rows 14 (ViT-L
    self-attention and InvPT's cross shape, at a cut batch), 7 (the ViT-L
    training shape), 13 (fast and safe, the ViT-L packed qkv at batch 2) and
    12 (Swin-B's stage 1 with its mask: dq, dk, dv and dbias). No atomics, a
    fixed summation order."""
    from mtt_tpu_torch.kernels.attention import (attn_core_bwd_cuda,
                                                 fused_attention,
                                                 fused_attention_qkv)
    from mtt_tpu_torch.kernels.window_attention import \
        window_attention_bwd_cuda
    if kernel == "attention_bwd":
        qkv = _rnd(gen, 2, 1029, 16 * 3 * 64)
        g = _rnd(gen, 2, 1029, 16 * 64)

        def run():
            return attn_core_bwd_cuda(qkv, g, 16, 0.125)
    elif kernel.startswith("attention_qkv"):
        qkv = _rnd(gen, 2, 1029, 16 * 3 * 64)

        def run():
            return fused_attention_qkv(qkv, 16, safe=kernel.endswith("safe"))
    elif kernel == "window_attention_bwd":
        BW, M, H = 128, 147, 8
        q, k, v = _rnd(gen, BW, M, 3, H, 32).unbind(2)
        bias = _rnd(gen, H, M, M, dtype=torch.float32)
        mask = torch.where(torch.rand(BW, M, M, generator=gen,
                                      device="cuda") < 0.3, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
        g = _rnd(gen, BW, M, H, 32)

        def run():
            return torch.cat([t.flatten().float() for t in
                              window_attention_bwd_cuda(q, k, v, bias, mask,
                                                        g, 32 ** -0.5, BW)])
    else:
        nq, nk, h, d = ((1029, 1029, 16, 64) if kernel == "attention_generic"
                        else (5120, 320, 2, 72))
        q, k, v = (_rnd(gen, 2, n, h, d, std=2.0) for n in (nq, nk, nk))

        def run():
            return fused_attention(q, k, v)
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_attention_generic_kernel_reads_strides(gen):
    """q, k, v as strided views: of one packed (B, N, 3, H, D) tensor, and
    a (B, N, H, D) transpose of a (B, H, N, D) tensor."""
    from mtt_tpu_torch.kernels.attention import fused_attention
    q, k, v = _rnd(gen, 2, 70, 3, 2, 72).unbind(2)
    _check(fused_attention(q, k, v),
           fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           impl="plain"))
    t = _rnd(gen, 2, 2, 70, 64).transpose(1, 2)
    _check(fused_attention(t, t, t), fused_attention(t, t, t, impl="plain"))


def test_attention_modules_go_through_kernels(gen):
    """``Attention`` without LN and ``dot_product_attention`` on the card:
    one launch each on its own count, within 0.1 relative RMS of an f32
    plain run of the same weights (as the model tests)."""
    import copy

    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import (Attention, dot_product_attention,
                                             init_weights)
    attn = Attention(256, 4, device="cuda", dtype=torch.bfloat16)
    init_weights(attn, gen)
    x = _rnd(gen, 2, 77, 256)
    q = _rnd(gen, 2, 50, 4, 64)
    _build.reset_counts()
    out = attn(x)
    o2 = dot_product_attention(q, q, q)
    assert _build.COUNTS == _counts(attention_qkv=1, attention_generic=1)
    ref = copy.deepcopy(attn).float()(x.float(), impl="plain")
    ref2 = dot_product_attention(q.float(), q.float(), q.float(),
                                 impl="plain")
    for got, want in ((out, ref), (o2, ref2)):
        err = ((got.float() - want).norm() / want.norm()).item()
        assert err <= 0.1, err


@pytest.mark.parametrize("C,Hd,rows", [
    (768, 384, 45), (1024, 384, 45), (576, 2304, 45), (288, 1152, 45),
    (144, 576, 45), (144, 80, 45), (512, 2048, 45), (256, 1024, 45),
    (128, 512, 45), (128, 512, 3), (1024, 4096, 3),
    (192, 768, 1), (192, 768, 127), (192, 768, 128), (192, 768, 129),
    (384, 1536, 1), (384, 1536, 127), (384, 1536, 128), (384, 1536, 129),
    (128, 512, 73728)])
def test_mlp_fc_kernel(gen, C, Hd, rows):
    """The ViT widths, the three InvPT stage widths with their hidden sizes
    (576 ends inside a 128-column tile and a 64-deep K stage), a hidden
    width under one tile, the Swin-B stage widths, also on the 3 prompt rows
    and on stage 0's 73,728 rows, and ViT-T's and ViT-S's widths on rows
    around the GEMM's 128-row tile."""
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    x = _rnd(gen, 3, rows // 3, C) if rows % 3 == 0 else _rnd(gen, rows, C)
    w1, b1 = _rnd(gen, Hd, C, std=C ** -0.5), _rnd(gen, Hd, std=0.1)
    w2, b2 = _rnd(gen, C, Hd, std=Hd ** -0.5), _rnd(gen, C, std=0.1)
    args = (x, w1, b1, w2, b2)
    _check(fused_mlp(*args), fused_mlp(*args, impl="plain"))


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_mlp_fc_kernel_biases_as_stored_and_repeat_bits(gen, bias_dtype):
    """Row 8's biases are read in their stored dtype (no cast launched), and
    two runs give equal bits (no split-K, no atomics), at the ViT-L step's
    shape (2 x 1029 rows, C 1024, hidden 4096)."""
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    C, Hd = 1024, 4096
    args = (_rnd(gen, 2, 1029, C), _rnd(gen, Hd, C, std=C ** -0.5),
            _rnd(gen, Hd, std=0.1, dtype=bias_dtype),
            _rnd(gen, C, Hd, std=Hd ** -0.5),
            _rnd(gen, C, std=0.1, dtype=bias_dtype))
    got = fused_mlp(*args)
    _check(got, fused_mlp(*args, impl="plain"))
    assert torch.equal(got, fused_mlp(*args))


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,C", [(8232, 1024), (8232, 768), (74, 192),
                                    (2058, 328)])
def test_qkv_proj_kernel(gen, rows, C, bias_dtype):
    """The qkv projection of rows 1-2 (one launch of the shared GEMM, bias
    epilogue) against its plain stage at ViT-L's eval shape, ViT-B's and
    ViT-T's (3C = 576, which the old kernel refused), and on the ViT-L
    step's 2058 rows with 3C = 984 (the half-tile schedule, ragged in rows
    and columns), the bias read as stored: one rounding on both sides, so 1
    bf16 ulp; two runs give equal bits."""
    from mtt_tpu_torch.kernels.attention import qkv_proj_cuda, qkv_proj_plain
    xn = _rnd(gen, rows, C)
    w = _rnd(gen, 3 * C, C, std=C ** -0.5)
    b = _rnd(gen, 3 * C, std=0.1, dtype=bias_dtype)
    got = qkv_proj_cuda(xn, w, b)
    _check(got, qkv_proj_plain(xn, w, b), ulps=1)
    assert torch.equal(got, qkv_proj_cuda(xn, w, b))


def test_gemm_wrappers_refuse_unaligned_views(gen):
    """Row 8 and the qkv projection read with TMA, 16-byte aligned data
    only: a view two bytes into its storage raises and does not fall
    back."""
    from mtt_tpu_torch.kernels.attention import qkv_proj_cuda
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    x = _rnd(gen, 64, 768)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    xv = buf[1:].view_as(x)
    xv.copy_(x)
    w1, b1 = _rnd(gen, 3072, 768, std=768 ** -0.5), _rnd(gen, 3072, std=0.1)
    w2, b2 = _rnd(gen, 768, 3072, std=3072 ** -0.5), _rnd(gen, 768, std=0.1)
    with pytest.raises(ValueError, match="aligned"):
        fused_mlp(xv, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="aligned"):
        qkv_proj_cuda(xv, _rnd(gen, 2304, 768), _rnd(gen, 2304))


@pytest.mark.parametrize("need_qkv", [False, True])
def test_attention_grads_through_kernels(gen, need_qkv):
    """The whole attention Function's gradients on the card (LN and qkv
    recomputed by the forward kernels, the core backward kernel, the closing
    products) against the same Function on the plain versions: relative RMS
    1e-2 per gradient (bf16 roundings flip differently on the two paths;
    a wiring fault gives order 1)."""
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
    B, N, H, D = 2, 77, 4, 64
    C = H * D
    leaves = [_rnd(gen, B, N, C),
              _rnd(gen, C, std=0.1, mean=1.0, dtype=torch.float32),
              _rnd(gen, C, std=0.1, dtype=torch.float32),
              _rnd(gen, 3 * C, C, std=C ** -0.5), _rnd(gen, 3 * C, std=0.1)]
    cot = [_rnd(gen, B, N, C), _rnd(gen, B, N, 3 * C), _rnd(gen, B, N, C)]
    grads = []
    for impl in ("cuda", "plain"):
        ins = [t.clone().requires_grad_() for t in leaves]
        out = fused_attention_ln_qkv(*ins, H, need_qkv=need_qkv, safe=True,
                                     impl=impl)
        out = out if need_qkv else (out,)
        torch.autograd.backward(out, cot[:len(out)])
        grads.append([t.grad.float() for t in ins])
    for g_k, g_p in zip(*grads):
        err = ((g_k - g_p).norm() / g_p.norm()).item()
        assert torch.isfinite(g_k).all() and err <= 1e-2, err


def test_train_step_goes_through_kernels(gen):
    """One ViT-B training step at 64x64 in bf16: every training kernel
    launches as often as the block schedule says, losses and gradients are
    finite, and the parameters with a gradient move."""
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet
    from mtt_tpu_torch.train import PASCAL_VITL
    from mtt_tpu_torch.utils.train_utils import Trainer, to_device

    tasks = ("semseg", "human_parts", "sal", "normals", "edge")
    num_out = {"semseg": 21, "human_parts": 7, "sal": 2, "normals": 3,
               "edge": 1}
    model = TaskPrompterNet(tasks, num_out, (64, 64), "TaskPrompter_vitB",
                            device="cuda")
    init_weights(model, gen)
    trainer = Trainer(model, PASCAL_VITL, tasks, torch.bfloat16,
                      generator=gen)
    batch = to_device(SyntheticMT(tasks, num_out, (64, 64)).batch(0, 2),
                      "cuda")
    before = [w.detach().clone() for w in trainer.master]
    _build.reset_counts()
    losses = trainer.backward(batch)
    torch.cuda.synchronize()
    # ViT-B: 12 blocks, taps after 3, 6, 9 and the last; drop-path > 0 on
    # blocks 1..11, which run LN + the plain MLP
    assert _build.COUNTS == _counts(layernorm=11 + 4 + 1, attention_cached=8,
                                    attention_emit=4, attention_bwd=12,
                                    mlp_ln_res=1, mlp_fc=11, task_decode=4)
    assert all(torch.isfinite(v) for v in losses.values())
    grads = [w.grad for w in model.parameters()]
    assert all(torch.isfinite(g).all() for g in grads)
    trainer.update()
    # every parameter with a gradient moves (the last block's prompt-row
    # update and the conv biases ahead of batch-statistics BN get none)
    assert all(not torch.equal(a, b) for a, b, g in
               zip(before, trainer.master, grads) if g.abs().sum() > 0)


@pytest.mark.parametrize("Lq,Lk,D,with_msg", [
    (150, 320, 72, True), (150, 320, 72, False), (64, 320, 144, True),
    (33, 320, 288, False), (100, 252, 72, True), (40, 10, 144, True)])
def test_invpt_attention_kernel(gen, Lq, Lk, D, with_msg):
    """Head dims 72 (padded to 80), 144 and 288, query counts that are not
    tile multiples, NYUD's kv length of 252 and a tiny one (both padded to
    16-key tiles), with and without a message. out: 4 bf16 ulps (p is rounded
    to bf16 at the same point; f32 sums in another order can flip it); fused
    (f32 on both sides, exact bf16 products): 0.01 ulps = 8e-5 of its
    scale."""
    from mtt_tpu_torch.kernels.invpt_attention import invpt_fused_attention
    B, H = 2, 2
    q = _rnd(gen, B, H, Lq, D)
    k, v = _rnd(gen, B, H, Lk, D), _rnd(gen, B, H, Lk, D)
    msg = w = b = None
    if with_msg:
        msg = _rnd(gen, B, H, Lq, Lk, dtype=torch.float32)
        w = _rnd(gen, H, 2 * H, std=0.5, dtype=torch.float32)
        b = _rnd(gen, H, std=0.1, dtype=torch.float32)
    scale = (2 * D) ** -0.5
    _check(invpt_fused_attention(q, k, v, msg, w, b, scale),
           invpt_fused_attention(q, k, v, msg, w, b, scale, impl="plain"),
           ulps=(4, 0.01))


@pytest.mark.parametrize("h0,w0,C,D,n", [(16, 16, 576, 576, 21),
                                         (14, 18, 576, 576, 40),
                                         (2, 5, 40, 72, 1)])
def test_invpt_tail_kernels(gen, h0, w0, C, D, n):
    """Both forms of the multi-scale tail at the PASCAL grid, on NYUD's
    non-square grid with 40 logits (two logit chunks) and at a small width
    with padded channels and a partial column segment: 4 bf16 ulps."""
    from mtt_tpu_torch.kernels.invpt_tail import (fused_ms_tail,
                                                  fused_ms_tail_head)
    xs = tuple(_rnd(gen, 2, h0 * m, w0 * m, C, std=0.5) for m in (1, 2, 4))
    kc = _rnd(gen, 3, 3, C, D, std=(9 * C) ** -0.5)
    inv = _rnd(gen, D, std=0.1, mean=1.0, dtype=torch.float32)
    addv = _rnd(gen, D, std=0.1, dtype=torch.float32)
    wh = _rnd(gen, D, n, std=D ** -0.5)
    bh = _rnd(gen, n, std=0.1, dtype=torch.float32)
    th, tw = 8 * h0, 8 * w0
    _check(fused_ms_tail(xs, kc, inv, addv, th, tw),
           fused_ms_tail(xs, kc, inv, addv, th, tw, impl="plain"))
    _check(fused_ms_tail_head(xs, kc, inv, addv, wh, bh, th, tw),
           fused_ms_tail_head(xs, kc, inv, addv, wh, bh, th, tw,
                              impl="plain"))


@pytest.mark.parametrize("n", [0, 40, 128])
@pytest.mark.parametrize("h0,w0", [(16, 16), (14, 18)])
def test_invpt_tail_kernels_shapes_and_repeat_bits(gen, h0, w0, n):
    """The tail at PASCAL's grid and NYUD's 14x18 at C = D = 576 (batch 2),
    without the head (n = 0) and with 40 and 128 logits (the widest the mix
    kernel keeps in registers, which takes the shallowest slab): within 4
    bf16 ulps of the plain version, and two runs give the same bits (Gm on
    the shared GEMM without split-K, the mix kernel's slabs added in a fixed
    order, no atomics)."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.invpt_tail import (fused_ms_tail,
                                                  fused_ms_tail_head)
    C = D = 576
    xs = tuple(_rnd(gen, 2, h0 * m, w0 * m, C, std=0.5) for m in (1, 2, 4))
    kc = _rnd(gen, 3, 3, C, D, std=(9 * C) ** -0.5)
    inv = _rnd(gen, D, std=0.1, mean=1.0, dtype=torch.float32)
    addv = _rnd(gen, D, std=0.1, dtype=torch.float32)
    th, tw = 8 * h0, 8 * w0
    if n:
        wh = _rnd(gen, D, n, std=D ** -0.5)
        bh = _rnd(gen, n, std=0.1, dtype=torch.float32)

        def run(impl=None):
            return fused_ms_tail_head(xs, kc, inv, addv, wh, bh, th, tw,
                                      impl=impl)
    else:
        def run(impl=None):
            return fused_ms_tail(xs, kc, inv, addv, th, tw, impl=impl)
    _build.reset_counts()
    first = run()
    assert _build.COUNTS == _counts(
        **{"invpt_tail_head" if n else "invpt_tail": 1})
    second = run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _check(first, run("plain"))


def test_invpt_tail_and_window_kernels_refuse_before_launch(gen):
    """Row 10 refuses a map that is not on a 16-byte boundary (its Gm
    launch reads the maps with TMA) and factors other than (8, 4, 2); row 11
    a head dim other than 32; nothing launches."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.invpt_tail import fused_ms_tail
    from mtt_tpu_torch.kernels.window_attention import fused_window_attention
    kc = _rnd(gen, 3, 3, 16, 24)
    inv, addv = torch.ones(24, device="cuda"), torch.zeros(24, device="cuda")
    xs = [_rnd(gen, 1, 2 * m, 2 * m, 16) for m in (1, 2, 4)]
    xs[0] = _rnd(gen, 4 * 16 + 1)[1:].view(1, 2, 2, 16)
    _build.reset_counts()
    with pytest.raises(ValueError, match="aligned"):
        fused_ms_tail(xs, kc, inv, addv, 16, 16)
    xs = [_rnd(gen, 1, 2 * m, 2 * m, 16) for m in (1, 2, 4)]
    with pytest.raises(ValueError, match="factors"):
        fused_ms_tail(xs, kc, inv, addv, 32, 32)
    q = _rnd(gen, 2, 19, 2, 64)
    with pytest.raises(ValueError, match="head dim 32"):
        fused_window_attention(q, q, q, _rnd(gen, 2, 19, 19,
                                             dtype=torch.float32), None,
                               0.125, 2)
    torch.cuda.synchronize()
    assert _build.COUNTS == _counts()


@pytest.mark.parametrize("tail_head", [False, True])
def test_invpt_model_goes_through_kernels(gen, tail_head):
    """InvPT on ViT-B (C = 768, head dim 64) at the full decoder width (576,
    288, 144) and 64x128 input in bf16: every kernel of the path launches as
    often as the module tree says, no plain version runs, and the logits'
    relative RMS error against an f32 run of the same weights stays within
    0.1 (as in chip_smoke.py)."""
    import copy

    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import INVPT_PASCAL_VITL, build_model

    model = build_model(dict(INVPT_PASCAL_VITL, backbone="vitB"),
                        img_size=(64, 128), tail_head=tail_head,
                        dtype=torch.bfloat16).eval()
    init_weights(model, gen)
    x = torch.randn(2, 64, 128, 3, generator=gen, device="cuda")
    _build.reset_counts()
    logits, preds = predict(model, x)
    torch.cuda.synchronize()
    assert _build.COUNTS == _counts(
        layernorm=1 + 6 + 3, attention_cached=12, mlp_ln_res=12, mlp_fc=3,
        invpt_attention=3,
        **{"invpt_tail_head" if tail_head else "invpt_tail": 5})
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref, _ = predict(copy.deepcopy(model).float(), x, impl="plain")
    for t in model.tasks:
        for got, want in ((logits[t], ref[t]), (logits["inter_preds"][t],
                                                ref["inter_preds"][t])):
            assert got.shape == want.shape
            r = want.float()
            err = ((got.float() - r).norm() / r.norm()).item()
            assert err <= 0.1, (t, err)
        assert preds[t].shape[:3] == (2, 64, 128)


WATTN_CASES = [  # BW, M, H, nW: the four Swin-B stages of a 768x1536 input,
    (512, 147, 4, 512), (128, 147, 8, 128), (32, 147, 16, 32),
    (8, 147, 32, 8),
    (6, 19, 3, 3),             # ragged and small: 4x4 windows, nW < BW
    (2, 16, 1, 2), (3, 161, 2, 1),    # a whole tile; one row past ten tiles
]


@pytest.mark.parametrize("BW,M,H,nW", WATTN_CASES)
@pytest.mark.parametrize("with_mask", [True, False])
def test_window_attention_kernel(gen, BW, M, H, nW, with_mask):
    """q, k, v as strided views of one packed qkv projection, as the Swin
    block hands them over; mask entries of 0 and -100. 2 bf16 ulps: p is
    rounded to bf16 at the same point on both sides, f32 sums in another
    order can flip that rounding."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.window_attention import fused_window_attention
    D = 32
    q, k, v = _rnd(gen, BW, M, 3, H, D).unbind(2)
    bias = _rnd(gen, H, M, M, dtype=torch.float32)
    mask = None
    if with_mask:
        mask = torch.where(torch.rand(nW, M, M, generator=gen,
                                      device="cuda") < 0.3, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
    _build.reset_counts()
    got = fused_window_attention(q, k, v, bias, mask, D ** -0.5, nW)
    assert _build.COUNTS == _counts(window_attention=1)
    assert got.shape == (BW, M, H, D)
    assert got.reshape(BW, M, H * D).is_contiguous()
    _check(got, fused_window_attention(q, k, v, bias, mask, D ** -0.5, nW,
                                       impl="plain"), ulps=2)
    # contiguous q, k, v take the same kernel
    _check(fused_window_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), bias, mask, D ** -0.5, nW),
           got, ulps=0)


@pytest.mark.parametrize("M", [147, 200])
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("BW,H", [(512, 4), (32, 16)])
def test_window_attention_kernel_stages_and_repeat_bits(gen, BW, H, with_mask,
                                                        M):
    """Row 11 at Swin-B's stages 0 and 2, with and without the shift mask,
    at its 147 tokens and at 200 (past the 160 of the old kernel's padded
    window): within 2 bf16 ulps of the plain version, and two runs give the
    same bits."""
    from mtt_tpu_torch.kernels.window_attention import \
        fused_window_attention_qkv
    qkv = _rnd(gen, BW, M, 3, H, 32)
    bias = _rnd(gen, H, M, M, dtype=torch.float32)
    mask = None
    if with_mask:
        mask = torch.where(torch.rand(BW, M, M, generator=gen,
                                      device="cuda") < 0.3, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
    first, second = (fused_window_attention_qkv(qkv, bias, mask, 32 ** -0.5,
                                                BW) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _check(first, fused_window_attention_qkv(qkv, bias, mask, 32 ** -0.5, BW,
                                             impl="plain"), ulps=2)


@pytest.mark.parametrize("BW,M,H,nW", WATTN_CASES[:-1])
@pytest.mark.parametrize("with_mask", [True, False])
def test_window_attention_bwd_kernel(gen, BW, M, H, nW, with_mask):
    """The backward kernel (dq, dk, dv into one packed gradient, dbias) on a
    CUDA tensor that requires grad, against the plain backward on the same
    inputs: dq, dk and dv within 4 bf16 ulps (dl and pn are rounded to bf16
    at the same points, f32 sums in another order can flip a rounding), dbias
    within 1e-4 of its largest value (f32 on both sides, summed over the
    windows in another order). Two runs give the same dbias bits."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.window_attention import (
        fused_window_attention_qkv, window_attention_bwd_plain)
    D = 32
    qkv = _rnd(gen, BW, M, 3, H, D)
    bias = _rnd(gen, H, M, M, dtype=torch.float32)
    g = _rnd(gen, BW, M, H, D)
    mask = None
    if with_mask:
        mask = torch.where(torch.rand(nW, M, M, generator=gen,
                                      device="cuda") < 0.3, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
    grads = []
    for _ in range(2):
        leaf, lb = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        _build.reset_counts()
        fused_window_attention_qkv(leaf, lb, mask, D ** -0.5, nW).backward(g)
        torch.cuda.synchronize()
        assert _build.COUNTS == _counts(window_attention=1,
                                        window_attention_bwd=1)
        grads.append((leaf.grad, lb.grad))
    assert torch.equal(grads[0][1], grads[1][1])
    assert torch.equal(grads[0][0], grads[1][0])
    dq, dk, dv, dbias = window_attention_bwd_plain(
        *qkv.unbind(2), bias, mask, g, D ** -0.5, nW)
    _check(grads[0][0].unbind(2), (dq, dk, dv), ulps=4)
    err = (grads[0][1] - dbias).abs().max().item()
    assert err <= 1e-4 * dbias.abs().max().item(), err


@pytest.mark.parametrize("BW,nW", [(29, 29), (58, 29)])
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("M", [1, 16, 17, 49, 147, 160])
def test_window_attention_bwd_kernel_ragged(gen, M, with_mask, BW, nW):
    """Row 12 at token counts from one to the 160 it takes, around the
    16-row strip and the 8-key tile, with a window count that is not a
    multiple of a block's chunk of windows (29 or 58 windows of 10 heads:
    the last chunk is short on a card of 132 SMs, or of 114), the mask of
    window w at w % nW, and g a strided view (the first 32 of 40
    columns). dq, dk, dv within 4 bf16 ulps, dbias within 1e-4 of its
    largest value, as in test_window_attention_bwd_kernel."""
    from mtt_tpu_torch.kernels.window_attention import (
        window_attention_bwd_cuda, window_attention_bwd_plain)
    H, D = 10, 32
    q, k, v = _rnd(gen, BW, M, 3, H, D).unbind(2)
    bias = _rnd(gen, H, M, M, dtype=torch.float32)
    g = _rnd(gen, BW, M, H, D + 8)[..., :D]
    assert not g.is_contiguous()
    mask = None
    if with_mask:
        mask = torch.where(torch.rand(nW, M, M, generator=gen,
                                      device="cuda") < 0.3, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
    dqkv, dbias = window_attention_bwd_cuda(q, k, v, bias, mask, g,
                                            D ** -0.5, nW)
    dq, dk, dv, want = window_attention_bwd_plain(q, k, v, bias, mask, g,
                                                  D ** -0.5, nW)
    _check(dqkv.unbind(2), (dq, dk, dv), ulps=4)
    err = (dbias - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


def test_window_attention_bwd_kernel_refusals(gen):
    """Past 160 tokens the backward's tiles do not fit: it raises, while the
    forward takes any token count."""
    from mtt_tpu_torch.kernels.window_attention import (
        window_attention_bwd_cuda, window_attention_cuda)
    q, k, v = _rnd(gen, 2, 161, 3, 1, 32).unbind(2)
    bias = _rnd(gen, 1, 161, 161, dtype=torch.float32)
    assert window_attention_cuda(q, k, v, bias, None, 0.2, 1).shape == \
        q.shape
    with pytest.raises(ValueError, match="shared memory"):
        window_attention_bwd_cuda(q, k, v, bias, None, q, 0.2, 1)


def test_swin_model_goes_through_kernels(gen):
    """A small TaskPrompter-Swin net at Swin-B's head dim (32) and window
    (12, so 147 tokens a window), depths (2, 2, 4, 2), 192x384 input in bf16
    with the detection head: the kernels launch as often as the block
    schedule says (the last block of each stage is a tap block and takes the
    composition), and every 2D map and detection level stays within 0.1
    relative RMS of an f32 run of the same weights (as in chip_smoke.py)."""
    import copy

    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.detection.det_params import default_det_params
    from mtt_tpu_torch.models.wrappers import TaskPrompterSwinNet

    model = TaskPrompterSwinNet(
        ("semseg", "depth", "3ddet"), {"semseg": 19, "depth": 1, "3ddet": 18},
        (192, 384), target_size=(96, 192), det_cfg=default_det_params(),
        embed_dim=128, depths=(2, 2, 4, 2), num_heads=(4, 8, 16, 32),
        window_size=12, dtype=torch.bfloat16).eval()
    init_weights(model, gen)
    x = torch.randn(1, 192, 384, 3, generator=gen, device="cuda")
    K = torch.tensor([[2262.52, 0, 1096.98], [0, 2265.30, 513.137],
                      [0, 0, 1.0]])
    _build.reset_counts()
    logits, preds = predict(model, x, cam_K=K)
    torch.cuda.synchronize()
    # 10 blocks: 6 on the kernel; 4 LayerNorms and 2 MLPs a block (3 and 1 in
    # the last); patch norm, 3 merge norms, final norm
    assert _build.COUNTS == _counts(window_attention=6, mlp_fc=19,
                                    layernorm=39 + 5)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref, _ = predict(copy.deepcopy(model).float(), x, impl="plain",
                         cam_K=K)
    pairs = [(t, logits[t], ref[t]) for t in ("semseg", "depth")]
    for name, gl, rl in zip(("cls", "bbox", "dir", "ctr"), logits["3ddet"],
                            ref["3ddet"]):
        pairs += [(f"{name}{i}", g, r) for i, (g, r) in enumerate(zip(gl, rl))]
    for what, got, want in pairs:
        assert got.shape == want.shape
        r = want.float()
        err = ((got.float() - r).norm() / r.norm()).item()
        assert err <= 0.1, (what, err)
    assert preds["semseg"].shape == (1, 96, 192)
    assert preds["3ddet"]["boxes3d"].shape == (1, 200, 9)


def test_swin_train_step_goes_through_kernels(gen):
    """One training step of a small TaskPrompter-Swin Cityscapes-3D net at
    Swin-B's head dim and window (as above, depths (2, 2, 4, 2), 192x384, one
    image, bf16, drop-path on): the window attention backward launches once
    for each block on the forward kernel and nothing raises; losses (every
    detection component) and gradients are finite, and the parameters with
    a gradient move."""
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.detection.det_params import default_det_params
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import TaskPrompterSwinNet
    from mtt_tpu_torch.train import CS3D_SWINB_TRAIN
    from mtt_tpu_torch.utils.train_utils import Trainer, to_device

    tasks = ("semseg", "depth", "3ddet")
    num_out = {"semseg": 19, "depth": 1, "3ddet": 18}
    model = TaskPrompterSwinNet(
        tasks, num_out, (192, 384), target_size=(96, 192),
        det_cfg=default_det_params(), embed_dim=128, depths=(2, 2, 4, 2),
        num_heads=(4, 8, 16, 32), window_size=12, device="cuda")
    init_weights(model, gen)
    trainer = Trainer(model, CS3D_SWINB_TRAIN, tasks, torch.bfloat16,
                      generator=gen)
    batch = to_device(SyntheticMT(tasks, num_out, (192, 384),
                                  label_size=(96, 192)).batch(0, 1), "cuda")
    before = [w.detach().clone() for w in trainer.master]
    _build.reset_counts()
    losses = trainer.backward(batch)
    torch.cuda.synchronize()
    assert _build.COUNTS == _counts(window_attention=6,
                                    window_attention_bwd=6, mlp_fc=19,
                                    layernorm=39 + 5)
    assert {k for k in losses if k.startswith("3ddet.")}
    assert all(torch.isfinite(v) for v in losses.values())
    grads = [w.grad for w in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    trainer.update()
    assert all(not torch.equal(a, b) for a, b, g in
               zip(before, trainer.master, grads) if g.abs().sum() > 0)
