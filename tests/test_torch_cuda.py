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

import os

import pytest
import torch

# cuBLAS's deterministic mode, for the rematted steps held to the plain
# steps' bits; it must be set before cuBLAS starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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


def _invpt_inputs(gen, B, Lq, Lk, D, with_msg, heads_last=False, std=1.0):
    """q, k, v (as (B, L, H, D) transposed to (B, H, L, D) views when
    ``heads_last``, the model's head split), and msg, w, b or None."""
    H = 2

    def qkv(L):
        if heads_last:
            return _rnd(gen, B, L, H, D, std=std).transpose(1, 2)
        return _rnd(gen, B, H, L, D, std=std)

    q, k, v = qkv(Lq), qkv(Lk), qkv(Lk)
    msg = w = b = None
    if with_msg:
        msg = _rnd(gen, B, H, Lq, Lk, dtype=torch.float32)
        w = _rnd(gen, H, 2 * H, std=0.5, dtype=torch.float32)
        b = _rnd(gen, H, std=0.1, dtype=torch.float32)
    return q, k, v, msg, w, b


# The bit-equal share of out against the plain version that the former
# kernel (32-row blocks, scores and p in shared memory, the head dim padded on
# the host) reached on these inputs, measured once on an H100 80GB HBM3 at
# 700 W (tools/torch_attention_ab.py --rows invpt, which draws the same
# inputs and holds the two kernels to each other in one run). The kernel must
# reach as much, less INVPT_SHARE_SLACK: room for another build of the
# plain version's matmul and softmax to move a few of its bits, far under
# the ~0.3 that rounding p against a running max costs.
INVPT_PARENT_SHARE = {"pascal0": 0.9989067912101746,
                      "pascal1": 0.999409019947052,
                      "pascal2": 0.9993362426757812,
                      "nyud0": 0.9986376166343689,
                      "nyud1": 0.9994703531265259,
                      "nyud2": 0.9995439648628235}
INVPT_SHARE_SLACK = 1e-4


@pytest.mark.parametrize("Lq,Lk,D,with_msg,B,tag", [
    (150, 320, 72, True, 2, None), (150, 320, 72, False, 2, None),
    (64, 320, 144, True, 2, None), (33, 320, 288, False, 2, None),
    (100, 252, 72, True, 2, None), (40, 10, 144, True, 2, None),
    (40, 10, 144, False, 2, None), (5000, 320, 72, True, 8, None),
    (320, 320, 288, False, 8, "pascal0"), (1280, 320, 144, True, 8, "pascal1"),
    (5120, 320, 72, True, 8, "pascal2"), (252, 252, 288, False, 8, "nyud0"),
    (1008, 252, 144, True, 8, "nyud1"), (4032, 252, 72, True, 8, "nyud2")])
def test_invpt_attention_kernel(gen, Lq, Lk, D, with_msg, B, tag):
    """Head dims 72 (its last k step zero-filled on chip), 144 and 288, query
    counts that are not tile multiples (150 and 33 against 16-row tiles,
    5000 against 64), NYUD's kv length of 252 and a tiny one of 10 (neither
    a multiple of the 16-key step; 10 also leaves the message's rows off the
    16-byte grid, so the wrapper pads them and returns fused as a view), with
    and without a message; and the six launches of the
    PASCAL and NYUD InvPT-ViT-L forwards at batch 8, on the model's strided
    (B, L, H, D) head views. out: 4 bf16 ulps (p is rounded to bf16 at the
    same point; f32 sums in another order can flip it); fused (f32 on both
    sides, exact bf16 products): 0.01 ulps = 8e-5 of its scale. Two runs
    give the same bits (no atomics), and at the forwards' shapes at least as
    many outputs are bit-equal to the plain version as the parent kernel's
    (``INVPT_PARENT_SHARE``, less ``INVPT_SHARE_SLACK``)."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.invpt_attention import invpt_fused_attention
    args = _invpt_inputs(gen, B, Lq, Lk, D, with_msg, heads_last=B == 8)
    scale = (2 * D) ** -0.5
    _build.reset_counts()
    got = invpt_fused_attention(*args, scale)
    assert _build.COUNTS == _counts(invpt_attention=1)
    want = invpt_fused_attention(*args, scale, impl="plain")
    _check(got, want, ulps=(4, 0.01))
    again = invpt_fused_attention(*args, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if tag:
        assert _bit_share(got[0], want[0]) >= \
            INVPT_PARENT_SHARE[tag] - INVPT_SHARE_SLACK


@pytest.mark.parametrize("with_msg", [False, True])
@pytest.mark.parametrize("D", [72, 144, 288])
def test_invpt_attention_plans_give_equal_bits(gen, D, with_msg):
    """Every block shape (1-4 row tiles of 16 query rows), ring depth and
    grid, persistent blocks that walk tiles included, computes each row the
    same way: all give the bits of the planned launch, which is within
    tolerance of the plain version. 300 query rows: the last tile is
    partial at every tile height."""
    from mtt_tpu_torch.kernels import invpt_attention as mod
    B, Lq, Lk = 2, 300, 320
    args = _invpt_inputs(gen, B, Lq, Lk, D, with_msg)
    scale = (2 * D) ** -0.5
    ref = mod.invpt_attention_cuda(*args, scale)
    _check(ref, mod.invpt_attention_plain(*args, scale), ulps=(4, 0.01))
    for rt in (1, 2, 3, 4):
        tiles = B * -(-Lq // (16 * rt))
        for stages in (2, 5):
            for grid in (tiles, 3):
                try:
                    mod.invpt_attention_plan(B, Lq, Lk, D, with_msg,
                                             (rt, stages, grid))
                except ValueError:
                    continue      # that many slots do not fit
                got = mod.invpt_attention_cuda(*args, scale,
                                               plan=(rt, stages, grid))
                torch.cuda.synchronize()
                assert all(torch.equal(x, y) for x, y in zip(got, ref)), \
                    (rt, stages, grid)


# the six launches of the InvPT-ViT-L forwards at batch 8 (PASCAL and NYUD
# stages 0-2): (Lq, Lk, head dim, with a message) -> the plan's row tiles on
# an H100's 132 SMs
INVPT_FORWARD_PLANS = [
    ((320, 320, 288, False), 2), ((1280, 320, 144, True), 3),
    ((5120, 320, 72, True), 4), ((252, 252, 288, False), 1),
    ((1008, 252, 144, True), 4), ((4032, 252, 72, True), 4)]
INVPT_SMEM_BLOCK = 232448   # dynamic shared memory a block may use on sm_90


@pytest.mark.parametrize("shape,rt_want", INVPT_FORWARD_PLANS)
def test_invpt_attention_plan_fits_and_fills_the_card(gen, shape, rt_want):
    """Each forward launch gets a plan that fits a block's shared memory,
    a ring of 2-8 slots, blocks on at least half the SMs, and (on 132 SMs)
    the row tiles a block that the kernel's cost model picks."""
    from mtt_tpu_torch.kernels.invpt_attention import invpt_attention_plan
    Lq, Lk, D, msg = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rt, stages, grid, smem = invpt_attention_plan(8, Lq, Lk, D, msg)
    if sms == 132:
        assert rt == rt_want
    assert smem <= INVPT_SMEM_BLOCK and 2 <= stages <= 8
    tiles = 8 * -(-Lq // (16 * rt))
    assert min(tiles, sms // 2) <= grid <= tiles


@pytest.mark.parametrize("B,Lq,Lk,D,msg", [
    (1, 1, 1, 8, False), (2, 33, 10, 144, True), (3, 700, 320, 480, True),
    (2, 5000, 64, 16, False), (1, 40, 252, 72, True)])
def test_invpt_attention_plan_edges(gen, B, Lq, Lk, D, msg):
    """Tiny and odd shapes plan too: one query row, one key, the widest head
    dim (two TMA boxes a row), a grid that never exceeds the tiles, and
    persistent blocks that walk tiles only with a ring no deeper than a
    tile's P.V steps; the plan chosen is one the kernel takes back as given."""
    from mtt_tpu_torch.kernels.invpt_attention import invpt_attention_plan
    rt, stages, grid, smem = invpt_attention_plan(B, Lq, Lk, D, msg)
    tiles = B * -(-Lq // (16 * rt))
    assert 1 <= grid <= tiles and smem <= INVPT_SMEM_BLOCK
    passes = -(-(D // 8) // (9 if D <= 72 else 18))
    if grid < tiles:
        assert stages - 1 <= passes * -(-Lk // (32 if msg else 64))
    assert invpt_attention_plan(B, Lq, Lk, D, msg, (rt, stages, grid)) == \
        (rt, stages, grid, smem)


@pytest.mark.parametrize("with_msg", [False, True])
def test_invpt_attention_takes_the_max_over_all_keys(gen, with_msg):
    """fused spreads past 30 along each row, the keys growing toward the
    end of the row so that the max mostly sits in a late 16-key step: p is
    rounded against the max over ALL keys, as the TPU kernel does, so at
    least 99% of the outputs are bit-equal to the plain version (a running
    max would round p against partial maxima and fall well short)."""
    from mtt_tpu_torch.kernels.invpt_attention import (
        invpt_attention_cuda, invpt_attention_plain)
    B, Lq, Lk, D = 2, 256, 320, 72
    q, k, v, msg, w, b = _invpt_inputs(gen, B, Lq, Lk, D, with_msg, std=5.0)
    ramp = torch.linspace(0.2, 1.0, Lk, device="cuda")[None, None, :, None]
    k = (k.float() * ramp).to(torch.bfloat16)
    if with_msg:
        msg = msg * 8.0
    scale = (2 * D) ** -0.5
    got = invpt_attention_cuda(q, k, v, msg, w, b, scale)
    want = invpt_attention_plain(q, k, v, msg, w, b, scale)
    _check(got, want, ulps=(4, 0.01))
    spread = want[1].amax(-1) - want[1].amin(-1)
    assert spread.median().item() > 30, spread.median().item()
    assert _bit_share(got[0], want[0]) >= 0.99


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


def _meter_batch(gen, tasks, num_out, shape):
    """Seeded post-processed predictions and labels on the card, ignore
    pixels included."""
    def u(*s):
        return torch.rand(*s, generator=gen, device="cuda")

    pred, gt = {}, {}
    for t in tasks:
        ign = u(*shape, 1) < 0.1
        if t in ("semseg", "human_parts"):
            pred[t] = (u(*shape) * num_out[t]).long()
            lab = (u(*shape, 1) * num_out[t]).floor()
        elif t == "normals":
            pred[t] = u(*shape, 3) * 255
            lab = u(*shape, 3) * 2 - 1
        elif t == "depth":
            pred[t] = u(*shape) * 10
            lab = u(*shape, 1) * 10
        else:
            pred[t] = u(*shape) * 255
            lab = (u(*shape, 1) < 0.3).float()
        gt[t] = torch.where(ign, 255.0, lab)
    return pred, gt


@pytest.mark.parametrize("db", ["PASCALContext", "NYUD"])
def test_meter_states_on_the_card_equal_the_cpu(gen, db):
    """Two ``PerformanceMeter`` updates of seeded predictions at 8 x 448 x
    576 on the card (NYUD: 40 classes) against the same meters on the CPU:
    counts equal, float sums within 1e-6 of themselves."""
    from mtt_tpu_torch.evaluation.meters import PerformanceMeter
    from mtt_tpu_torch.models.wrappers import (INVPT_PASCAL_VITL,
                                               NYUD_INVPT_VITL, task_table)

    p = {"PASCALContext": INVPT_PASCAL_VITL, "NYUD": NYUD_INVPT_VITL}[db]
    tasks, num_out = task_table(db, p["task_dictionary"])
    card = PerformanceMeter(p, tasks, device="cuda")
    cpu = PerformanceMeter(p, tasks, device="cpu")
    for _ in range(2):
        pred, gt = _meter_batch(gen, tasks, num_out, (8, 448, 576))
        card.update(pred, gt)
        cpu.update({t: v.cpu() for t, v in pred.items()},
                   {t: v.cpu() for t, v in gt.items()})
    for t in tasks:
        for k, v in card.states[t].items():
            assert v.device.type == "cuda"
            w = cpu.states[t][k]
            if w.dtype == torch.int64:
                assert torch.equal(v.cpu(), w), (t, k)
            else:
                torch.testing.assert_close(v.cpu(), w, rtol=1e-6, atol=0.0)
    assert card.get_score().keys() == cpu.get_score().keys()


def test_prefetch_to_device_equals_the_host_batches(gen):
    """``prefetch_to_device`` over loader batches (ViT-T-sized synthetic
    samples through ``TrainTransforms``): every array on the card equals
    the host batch's, ``meta`` passes through, and the copies came from
    pinned memory without blocking."""
    from mtt_tpu_torch.data.loader import MultiTaskLoader, prefetch_to_device
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.data.transforms import TrainTransforms

    tasks = ("semseg", "sal", "normals", "edge")
    num_out = {"semseg": 21, "sal": 2, "normals": 3, "edge": 1}
    ds = SyntheticMT(tasks, num_out, (64, 80), length=7,
                     transform=TrainTransforms((64, 80)))
    loader = MultiTaskLoader(ds, 2, seed=1)
    host = list(loader)
    dev = list(prefetch_to_device(loader, "cuda"))
    torch.cuda.synchronize()
    assert len(dev) == len(host) == 3
    for d, h in zip(dev, host):
        assert d["meta"] == h["meta"]
        for k, v in h.items():
            if k != "meta":
                assert d[k].device.type == "cuda"
                assert torch.equal(d[k].cpu(), torch.from_numpy(v)), k


def test_checkpoint_restore_on_the_card_is_bit_equal(gen, tmp_path):
    """A ViT-B trainer (bf16 model, f32 master, drop-path on) takes a step,
    saves, takes another; a second trainer restored from the checkpoint
    takes the same step: under deterministic algorithms every master
    weight, Adam moment, BN statistic and loss is equal to the bit."""
    import os
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet
    from mtt_tpu_torch.train import PASCAL_VITL
    from mtt_tpu_torch.utils.train_utils import Trainer, to_device

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    tasks = ("semseg", "human_parts", "sal", "normals", "edge")
    num_out = {"semseg": 21, "human_parts": 7, "sal": 2, "normals": 3,
               "edge": 1}

    def trainer(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        model = TaskPrompterNet(tasks, num_out, (64, 64),
                                "TaskPrompter_vitB", device="cuda")
        init_weights(model, g)
        return Trainer(model, PASCAL_VITL, tasks, torch.bfloat16, g)

    data = SyntheticMT(tasks, num_out, (64, 64))
    batches = [to_device(data.batch(2 * i, 2), "cuda") for i in range(2)]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a = trainer(3)
        a.step(batches[0])
        a.save_checkpoint(str(tmp_path))
        b = trainer(4)
        assert b.restore_checkpoint(str(tmp_path)) == 1
        la, lb = a.step(batches[1]), b.step(batches[1])
    finally:
        torch.use_deterministic_algorithms(was)
    assert all(torch.equal(la[k], lb[k]) for k in la)
    for ma, mb in zip(a.master, b.master):
        assert torch.equal(ma, mb)
        sa, sb = a.optimizer.state[ma], b.optimizer.state[mb]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for (n, x), (_, y) in zip(a.model.named_buffers(),
                              b.model.named_buffers()):
        assert torch.equal(x, y), n


def _read_png(path):
    """A plain decoder of the unfiltered 8-bit grey / RGB PNGs that
    ``write_png`` makes (the card's machine has no cv2)."""
    import struct
    import zlib
    import numpy as np
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert zlib.crc32(kind + body) & 0xFFFFFFFF == crc
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, colour = hdr[:4]
    assert depth == 8 and colour in (0, 2)
    c = 3 if colour == 2 else 1
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all()
    img = raw[:, 1:].reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def test_png_encoder_decodes_to_the_array(tmp_path):
    """``write_png`` of seeded uint8 grey and RGB maps (odd sizes, 0 and
    255 included) decodes to the same arrays."""
    import numpy as np
    from mtt_tpu_torch.evaluation.save_preds import write_png
    rng = np.random.default_rng(0)
    for shape in ((37, 53), (5, 7, 3), (64, 64, 1)):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        a.flat[0], a.flat[-1] = 0, 255
        write_png(str(tmp_path / "x.png"), a)
        got = _read_png(str(tmp_path / "x.png"))
        assert np.array_equal(got, a[..., 0] if a.ndim == 3 and
                              a.shape[2] == 1 else a)


def test_main_refuses_float32_on_the_card(tmp_path, monkeypatch):
    """Training at ``--dtype float32`` on the card raises before anything is
    built, naming ROADMAP.md item 1.14 (rows 7 and 8 have no f32 form yet),
    as InvPT at float32 does, and a TaskPrompter-ViT YAML whose task decode
    takes the split form; ``--run_mode infer --dtype float32`` of a
    TaskPrompter-ViT config runs its eval forward through the f32 kernels
    (the val set cut to one batch here), TF32 off during the call and the
    flags as they were after it."""
    import os
    from mtt_tpu_torch import main as port_main
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.utils import common_config as cc
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.chdir(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    vitb = os.path.join(root, "configs/pascal/taskprompter_vitBp16.yml")
    with pytest.raises(ValueError, match="item 1.14"):
        port_main.main(["--config_exp", vitb, "--dtype", "float32"])
    with pytest.raises(ValueError, match="item 1.14"):
        port_main.main(["--config_exp", os.path.join(
            root, "configs/pascal/invpt_vitLp16.yml"), "--run_mode", "infer",
            "--dtype", "float32"])
    # a decode past the one launch's tar 304 / F 352: the split form
    with open(vitb) as f:
        text = f.read().replace("\nembed_dim: 300\n", "\nembed_dim: 768\n")
    wide = tmp_path.parent / f"{tmp_path.name}_vitb768.yml"
    wide.write_text(text)
    with pytest.raises(ValueError, match="split form.*item 1.14"):
        port_main.main(["--config_exp", str(wide), "--run_mode", "infer",
                        "--dtype", "float32"])
    assert not os.listdir(tmp_path)

    real = cc.get_dataset

    def one_batch(p, split, transforms=None, overfit=False):
        ds = real(p, split, transforms, overfit)
        if split != "train":
            ds.length = int(p["valBatch"])
        return ds
    monkeypatch.setattr(cc, "get_dataset", one_batch)
    seen = {}
    from mtt_tpu_torch.utils import train_utils
    real_test_phase = train_utils.test_phase

    def spy(p, model, loader, **kw):
        seen["dtype"] = next(model.parameters()).dtype
        seen["tf32"] = (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32)
        _build.reset_counts()
        scores = real_test_phase(p, model, loader, **kw)
        seen["counts"] = dict(_build.COUNTS)
        return scores
    monkeypatch.setattr(train_utils, "test_phase", spy)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    assert port_main.main(["--config_exp", vitb, "--run_mode", "infer",
                           "--dtype", "float32"]) == 0
    assert seen["dtype"] == torch.float32 and seen["tf32"] == (False, False)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags
    c = seen["counts"]
    assert c["attention_cached_f32"] == 8 and c["attention_emit_f32"] == 4
    assert c["mlp_ln_res_f32"] == 12 and c["task_decode_f32"] == 4
    assert c["head_up4_f32"] == 5 and c["layernorm_f32"] == 5
    assert all(v == 0 for k, v in c.items() if not k.endswith("_f32"))


# ---- the f32 forms (rows 1-6, 13, 14) against their plain versions --------

def _check_f32(got, want, tol=1e-5):
    """Relative RMS error ``tol`` per output: kernel and plain version are
    both f32 throughout and differ only in the order of their f32 sums (a
    bf16 shortcut would read about 1e-2)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert torch.isfinite(g).all()
        err = ((g.double() - w.double()).norm() / w.double().norm()).item()
        assert err <= tol, err


@pytest.fixture
def no_tf32():
    """The plain versions' products in full f32."""
    from mtt_tpu_torch.utils.precision import exact_f32
    with exact_f32():
        yield


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 37, 1024), (5, 64), (2, 9, 1536),
                                   (3, 11, 4096), (2, 5, 830), (7, 6),
                                   (2, 3, 8196), (2, 16384), (1025, 1024)])
def test_layernorm_kernel_f32(gen, no_tf32, shape, param_dtype):
    """The f32 form on packed rows (widths in 16-byte chunks of 4), ragged
    ones (830, 6: value by value) and rows past 2048 columns (four warps)."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    C = shape[-1]
    x = _rnd(gen, *shape, std=2.0, mean=0.5, dtype=torch.float32)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=param_dtype)
    b = _rnd(gen, C, std=0.1, dtype=param_dtype)
    _build.reset_counts()
    got = fused_layernorm(x, g, b)
    assert _build.COUNTS == _counts(layernorm_f32=1)
    _check_f32(got, fused_layernorm(x, g, b, impl="plain"))


@pytest.mark.parametrize("need_qkv", [False, True])
@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("N,C,H", [(77, 256, 4), (1029, 1024, 16),
                                   (65, 192, 4), (129, 96, 2)])
def test_attention_front_half_f32(gen, no_tf32, need_qkv, safe, N, C, H):
    """Rows 1-2 at f32: LN, the projection on the f32 GEMM and the core, at
    head dims 64, 48 (tile 64) and 48 with 3 heads of 32 rows; every output
    of the emit path."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
    f32 = torch.float32
    x = _rnd(gen, 2, N, C, dtype=f32)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=f32)
    be = _rnd(gen, C, std=0.1, dtype=f32)
    w = _rnd(gen, 3 * C, C, std=C ** -0.5, dtype=f32)
    bq = _rnd(gen, 3 * C, std=0.1, dtype=f32)
    _build.reset_counts()
    got = fused_attention_ln_qkv(x, g, be, w, bq, H, need_qkv=need_qkv,
                                 safe=safe)
    want = _counts(attention_emit_f32=1, layernorm_f32=1) if need_qkv \
        else _counts(attention_cached_f32=1)
    assert _build.COUNTS == want
    _check_f32(got, fused_attention_ln_qkv(x, g, be, w, bq, H,
                                           need_qkv=need_qkv, safe=safe,
                                           impl="plain"))


@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 129, 1029])
@pytest.mark.parametrize("H,D", [(4, 16), (16, 64), (2, 72), (2, 128),
                                 (3, 20)])
def test_attention_qkv_kernel_f32(gen, no_tf32, N, H, D, safe):
    """Row 13 (the core alone) at f32: ragged key tiles, head dims 16-128
    (72 in the 128 tile, 20 zero-padded to 24), fast and safe; logits
    spread so that the safe softmax's max matters."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.attention import fused_attention_qkv
    qkv = _rnd(gen, 2, N, H * 3 * D, std=1.5, dtype=torch.float32)
    _build.reset_counts()
    got = fused_attention_qkv(qkv, H, safe=safe)
    assert _build.COUNTS == _counts(attention_qkv_f32=1)
    _check_f32(got, fused_attention_qkv(qkv, H, safe=safe, impl="plain"))


@pytest.mark.parametrize("Nq,Nk,H,D", [(77, 77, 4, 64), (1029, 1029, 16, 64),
                                       (300, 33, 2, 72), (5, 1, 3, 8)])
def test_attention_generic_kernel_f32(gen, no_tf32, Nq, Nk, H, D):
    """Row 14 at f32 (the Generic policy: natural exp after the max over
    all keys) on strided views of packed tensors, as the module API hands
    them over."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.attention import fused_attention
    f32 = torch.float32
    q = _rnd(gen, 2, Nq, H, 2 * D, std=2.0, dtype=f32)[..., :D]
    kv = _rnd(gen, 2, Nk, 2, H, D, dtype=f32)
    k, v = kv[:, :, 0], kv[:, :, 1]
    _build.reset_counts()
    got = fused_attention(q, k, v)
    assert _build.COUNTS == _counts(attention_generic_f32=1)
    _check_f32(got, fused_attention(q, k, v, impl="plain"))


@pytest.mark.parametrize("rows,C,Hd", [(77, 256, 1024), (8232, 1024, 4096),
                                       (129, 166, 664), (3, 768, 3072)])
def test_mlp_ln_res_kernel_f32(gen, no_tf32, rows, C, Hd):
    """Row 4 at f32: LN, fc1 + GELU and fc2 + residual on the f32 GEMM; 166
    runs zero-padded to 168 (the LayerNorm's padded pitch)."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res
    f32 = torch.float32
    x = _rnd(gen, rows, C, dtype=f32)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=f32)
    be = _rnd(gen, C, std=0.1, dtype=f32)
    w1 = _rnd(gen, Hd, C, std=C ** -0.5, dtype=f32)
    b1 = _rnd(gen, Hd, std=0.1, dtype=f32)
    w2 = _rnd(gen, C, Hd, std=Hd ** -0.5, dtype=f32)
    b2 = _rnd(gen, C, std=0.1, dtype=f32)
    _build.reset_counts()
    got = fused_mlp_ln_res(x, g, be, w1, b1, w2, b2)
    assert _build.COUNTS == _counts(mlp_ln_res_f32=1)
    _check_f32(got, fused_mlp_ln_res(x, g, be, w1, b1, w2, b2,
                                     impl="plain"))


def _decode_inputs_f32(gen, B, S, C, T, G, tar, fin):
    f32 = torch.float32
    return (_rnd(gen, B, S, C, dtype=f32), _rnd(gen, B, T, S, G, dtype=f32),
            _rnd(gen, B, T, C, dtype=f32),
            _rnd(gen, T, tar, C, std=C ** -0.5, dtype=f32),
            _rnd(gen, T, tar, std=0.1, dtype=f32),
            _rnd(gen, T, tar, C, std=C ** -0.5, dtype=f32),
            _rnd(gen, T, tar, std=0.1, dtype=f32),
            _rnd(gen, T, fin, 2 * tar, std=(2 * tar) ** -0.5, dtype=f32),
            _rnd(gen, T, fin, std=0.1, dtype=f32))


@pytest.mark.parametrize("B,S,C,T,G,tar,fin", [
    (2, 1024, 1024, 5, 16, 300, 350), (2, 77, 768, 5, 12, 300, 350),
    (1, 50, 256, 3, 4, 20, 28), (2, 33, 64, 2, 4, 304, 352),
    (1, 31, 128, 1, 2, 4, 2)])
def test_task_decode_kernel_f32(gen, no_tf32, B, S, C, T, G, tar, fin):
    """Row 5's one launch at f32: ViT-L's and ViT-B's widths (tar 300, F
    350), ragged row tiles, the one launch's widest (304, 352) and
    narrowest; then the split form, which has no f32 form yet."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode
    args = _decode_inputs_f32(gen, B, S, C, T, G, tar, fin)
    _build.reset_counts()
    got = fused_task_decode(*args)
    assert _build.COUNTS == _counts(task_decode_f32=1)
    _check_f32(got, fused_task_decode(*args, impl="plain"))


def test_task_decode_split_form_refuses_f32(gen):
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode
    args = _decode_inputs_f32(gen, 1, 16, 64, 2, 4, 312, 40)
    with pytest.raises(TypeError, match="item 1.14"):
        fused_task_decode(*args)


@pytest.mark.parametrize("B,gh,gw,C,n", [(8, 32, 32, 350, 21), (2, 8, 12, 350, 7),
                                         (2, 28, 36, 768, 40), (1, 8, 8, 64, 1),
                                         (1, 12, 8, 100, 128)])
def test_head_up4_kernel_f32(gen, no_tf32, B, gh, gw, C, n):
    """Row 6 at f32: Gm on the f32 GEMM and the mix kernel at f32 (slabs
    of 192 channels: PASCAL's 352 in two, NYUD's 768 in four), n from 1 to
    128."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.head_up4 import fused_up4_head
    f32 = torch.float32
    x = _rnd(gen, B, gh, gw, C, std=0.5, dtype=f32)
    kc = _rnd(gen, 3, 3, C, C, std=(9 * C) ** -0.5, dtype=f32)
    inv = _rnd(gen, C, std=0.1, mean=1.0, dtype=f32)
    addv = _rnd(gen, C, std=0.1, dtype=f32)
    kp = _rnd(gen, C, n, std=C ** -0.5, dtype=f32)
    _build.reset_counts()
    got = fused_up4_head(x, kc, inv, addv, kp)
    assert _build.COUNTS == _counts(head_up4_f32=1)
    _check_f32(got, fused_up4_head(x, kc, inv, addv, kp, impl="plain"))


# ---- the 3xTF32 kernels: the f32 GEMM and the f32 attention core ----------

def _gemm_f32_plain(a, w, epi, bias, res):
    """The f32 GEMM's function in exact f32 (TF32 off): the epilogues of
    csrc/gemm.cuh in their order (GELU, residual, bias, none)."""
    from mtt_tpu_torch.kernels.mlp import gelu_erf_poly
    acc = a @ w.t()
    return (gelu_erf_poly(acc + bias), acc + bias + res, acc + bias,
            acc)[epi]


@pytest.mark.parametrize("epi", [0, 1, 2, 3])
@pytest.mark.parametrize("M,N,K,lda", [(1, 4, 12, 12), (77, 4, 100, 108),
                                       (129, 257, 36, 40),
                                       (300, 520, 1028, 1036),
                                       (5, 1000, 4, 8),
                                       (8232, 3072, 1024, 1024)])
def test_gemm_f32_kernel(gen, no_tf32, epi, M, N, K, lda):
    """``mtt_gemm_f32`` (3xTF32 on wgmma) at ragged M, N and K (K = 4 x odd,
    N = 4, M = 1) and the qkv projection's shape, A read at a row pitch lda
    past K, out and res at a pitch ldo past N, under all four epilogues:
    within 1e-5 relative RMS of the exact f32 product, the columns past N
    untouched, two launches with equal bits."""
    from mtt_tpu_torch.kernels import _build
    f32 = torch.float32
    ldo = -(-N // 4) * 4 + 4
    a = _rnd(gen, M, lda, dtype=f32)[:, :K]
    w = _rnd(gen, N, K, std=K ** -0.5, dtype=f32)
    bias = _rnd(gen, N, std=0.1, dtype=f32)
    res = _rnd(gen, M, ldo, dtype=f32)[:, :N]

    def call():
        out = torch.full((M, ldo), 7.0, device="cuda")
        _build.check(_build.lib().mtt_gemm_f32(
            a.data_ptr(), lda, w.data_ptr(), out.data_ptr(), ldo,
            bias.data_ptr() if epi != 3 else None,
            res.data_ptr() if epi == 1 else None, M, N, K, epi,
            _build.stream()), "mtt_gemm_f32")
        return out

    got, again = call(), call()
    _check_f32(got[:, :N], _gemm_f32_plain(a, w, epi, bias, res))
    assert (got[:, N:] == 7.0).all()
    assert torch.equal(got, again)


def _qkv_packed(q, k, v):
    """Head-major packed (B, N, H*3*D) from (B, N, H, D) q, k, v."""
    B, N, H, D = q.shape
    return torch.stack([q, k, v], 3).reshape(B, N, H * 3 * D).contiguous()


def _attn_f32_twice(policy, q, k, v):
    """(kernel output, again, plain version) of the f32 core: Generic through
    ``fused_attention``, Fast and Safe through ``fused_attention_qkv`` on the
    packed q, k, v (Nq = Nk)."""
    from mtt_tpu_torch.kernels.attention import (fused_attention,
                                                 fused_attention_qkv)
    if policy == "generic":
        def run(impl=None):
            return fused_attention(q, k, v, impl=impl)
    else:
        qkv, H = _qkv_packed(q, k, v), q.shape[2]

        def run(impl=None):
            return fused_attention_qkv(qkv, H, safe=policy == "safe",
                                       impl=impl)
    return run(), run(), run("plain")


@pytest.mark.parametrize("policy", ["fast", "safe", "generic"])
@pytest.mark.parametrize("Nk", [1, 5, 65, 1029])
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
def test_attention_f32_key_tails_and_head_dims(gen, no_tf32, policy, Nk, D):
    """The f32 core at key counts 1, 5, 65 and 1029 (= 16 x 64 + 5: ragged
    last tiles) and head dims 16-128 under each policy: within 1e-5 of its
    plain version, two launches with equal bits. Generic takes 77 queries,
    Fast and Safe attend over Nk tokens."""
    f32 = torch.float32
    nq = 77 if policy == "generic" else Nk
    q = _rnd(gen, 2, nq, 2, D, std=1.5, dtype=f32)
    k, v = _rnd(gen, 2, Nk, 2, D, dtype=f32), _rnd(gen, 2, Nk, 2, D, dtype=f32)
    got, again, want = _attn_f32_twice(policy, q, k, v)
    _check_f32(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("policy", ["safe", "generic"])
def test_attention_f32_rescales_every_key_tile(gen, no_tf32, policy):
    """Scores that rise along the keys (q positive, k drifting up by 4 over
    the keys: about 2.6 a 64-key tile against a spread of 0.4, up to about
    45), so that every key tile raises the running max and the row max sits
    in the last tile: the online rescale against the plain version's exact
    max, 1e-5, equal bits."""
    f32 = torch.float32
    B, N, H, D = 2, 1029, 2, 64
    q = _rnd(gen, B, N, H, D, dtype=f32).abs() + 0.5
    drift = torch.linspace(0.0, 4.0, N, device="cuda")[None, :, None, None]
    k = _rnd(gen, B, N, H, D, std=0.25, dtype=f32) + drift
    v = _rnd(gen, B, N, H, D, dtype=f32)
    got, again, want = _attn_f32_twice(policy, q, k, v)
    _check_f32(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("policy", ["safe", "generic"])
def test_attention_f32_large_scores(gen, no_tf32, policy):
    """Scores up to about +-1e3 (q and k of std 17 at head dim 64; the Safe
    policy's log2 units reach 1.4e3): no clamp, no overflow; finite and
    within 1e-5 of the plain version's exact max."""
    f32 = torch.float32
    q = _rnd(gen, 2, 257, 2, 64, std=17.0, dtype=f32)
    k = _rnd(gen, 2, 257, 2, 64, std=17.0, dtype=f32)
    v = _rnd(gen, 2, 257, 2, 64, dtype=f32)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 64 ** -0.5
    assert 5e2 < s.abs().max().item() < 2e3
    got, again, want = _attn_f32_twice(policy, q, k, v)
    _check_f32(got, want)
    assert torch.equal(got, again)


def test_f32_refusals_on_the_card(gen):
    """Kernels without an f32 form raise naming ROADMAP.md item 1.14 (row 8,
    row 7's backward, rows 11 and 9); a dtype with no form raises; nothing
    is cast to reach a kernel."""
    from mtt_tpu_torch.kernels.attention import (attn_core_bwd_cuda,
                                                 fused_attention_qkv)
    from mtt_tpu_torch.kernels.invpt_attention import invpt_attention_cuda
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    from mtt_tpu_torch.kernels.window_attention import window_attention_cuda
    f32 = torch.float32
    x = _rnd(gen, 3, 64, dtype=f32)
    w1, w2 = _rnd(gen, 128, 64, dtype=f32), _rnd(gen, 64, 128, dtype=f32)
    with pytest.raises(TypeError, match="item 1.14"):
        fused_mlp(x, w1, _rnd(gen, 128, dtype=f32), w2,
                  _rnd(gen, 64, dtype=f32))
    qkv = _rnd(gen, 2, 9, 3 * 64, dtype=f32)
    with pytest.raises(TypeError, match="item 1.14"):
        attn_core_bwd_cuda(qkv, _rnd(gen, 2, 9, 64, dtype=f32), 1, 0.125)
    q = _rnd(gen, 2, 147, 4, 32, dtype=f32)
    with pytest.raises(TypeError, match="item 1.14"):
        window_attention_cuda(q, q, q, _rnd(gen, 4, 147, 147, dtype=f32),
                              None, 0.17, 1)
    qi = _rnd(gen, 1, 2, 64, 72, dtype=f32)
    with pytest.raises(TypeError, match="item 1.14"):
        invpt_attention_cuda(qi, qi, qi, None, None, None, 72 ** -0.5)
    with pytest.raises(TypeError, match="float16"):
        fused_attention_qkv(qkv.half(), 1)


def test_collectives_on_the_card(gen, tmp_path):
    """Two ranks on the card (gloo on one card shared, NCCL on a card each):
    ``all_reduce_sum``'s forward and summed-cotangent gradient, and
    ``all_reduce_grads`` with a gradient that rank 1 lacks (summed as zeros,
    its bf16 kept) and one that no rank has (left None), as the CPU test
    ``tests/test_torch_parallel.py`` holds them."""
    import torch_dist_worker as W
    procs = W.launch([dict(name="collectives")], str(tmp_path),
                     device="cuda")
    for ranks in W.join(procs, str(tmp_path), timeout=240):
        c = ranks[0]
        assert torch.equal(c["y"], 2 * torch.arange(4.0) + 3)
        assert torch.equal(c["x_grad"], torch.full((4,), 3.0))
        assert torch.equal(c["a"], torch.full((3,), 3.0))
        assert c["b_dtype"] == torch.bfloat16
        assert torch.equal(c["b"], torch.ones(2, dtype=torch.bfloat16))
        assert c["c"] is None


def test_jpeg_fixtures_decode_to_pixels_json(gen):
    """On the card's machine (no PIL, no cv2): its g++ builds the JPEG
    decoder, which decodes the committed fixtures (tests/data/jpeg) to the
    pixels whose SHA-256 ``pixels.json`` records from PIL (``pil`` mode)
    and cv2 (``cv2_color``, EXIF orientation applied)."""
    import hashlib
    import json
    import os
    import numpy as np
    from mtt_tpu_torch.data.image_io import read_image
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
    with open(os.path.join(root, "pixels.json")) as f:
        table = json.load(f)
    assert len(table) == 5
    for name, entry in table.items():
        for key, mode in (("pil", "pil"), ("cv2", "cv2_color")):
            a = np.ascontiguousarray(read_image(os.path.join(root, name),
                                                mode))
            assert list(a.shape) == entry[key]["shape"], (name, key)
            assert hashlib.sha256(a.tobytes()).hexdigest() == \
                entry[key]["sha256"], (name, key)


def _remat_small_net(kind, gen):
    """(model, config, batch) on the card: InvPT on ViT-B (head dim 64) at
    64x128, batch 2, or the small Swin of
    ``test_swin_train_step_goes_through_kernels`` at 192x384, one image;
    seeded weights, drop-path on."""
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.detection.det_params import default_det_params
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import (INVPT_PASCAL_VITL,
                                               TaskPrompterSwinNet,
                                               build_model, task_table)
    from mtt_tpu_torch.train import CS3D_SWINB_TRAIN, INVPT_PASCAL_VITL_TRAIN
    from mtt_tpu_torch.utils.train_utils import to_device
    if kind == "invpt":
        p = dict(INVPT_PASCAL_VITL_TRAIN, backbone="vitB")
        model = build_model(p, img_size=(64, 128), device="cuda")
        tasks, num_out = task_table(p["train_db_name"], p["task_dictionary"])
        data = SyntheticMT(tasks, num_out, (64, 128)).batch(0, 2)
    else:
        p = CS3D_SWINB_TRAIN
        tasks = ("semseg", "depth", "3ddet")
        num_out = {"semseg": 19, "depth": 1, "3ddet": 18}
        model = TaskPrompterSwinNet(
            tasks, num_out, (192, 384), target_size=(96, 192),
            det_cfg=default_det_params(), embed_dim=128, depths=(2, 2, 4, 2),
            num_heads=(4, 8, 16, 32), window_size=12, device="cuda")
        data = SyntheticMT(tasks, num_out, (192, 384),
                           label_size=(96, 192)).batch(0, 1)
    init_weights(model, gen)
    return model, p, tasks, to_device(data, "cuda")


@pytest.mark.parametrize("kind", ["invpt", "swin"])
def test_remat_step_on_the_kernels_equals_plain_bits(gen, kind):
    """A rematted bf16 training step through the kernels, on deterministic
    library algorithms, gives the plain step's losses, gradients, BN
    running statistics and drop-path generator state to the bit; the
    rematted blocks' forward launches count twice (InvPT on ViT-B: 12
    blocks, block 0 the fused half-block; the small Swin: 10 blocks, 4 of
    them tap blocks on the composition)."""
    import copy

    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.utils.train_utils import Trainer

    model, p, tasks, batch = _remat_small_net(kind, gen)
    runs = []
    for remat in (False, True):
        m = copy.deepcopy(model)
        m.backbone.remat = remat
        if kind == "swin":
            m.remat = remat
        g = torch.Generator(device="cuda").manual_seed(3)
        trainer = Trainer(m, p, tasks, torch.bfloat16, generator=g)
        _build.reset_counts()
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            losses = trainer.backward(batch)
        finally:
            torch.use_deterministic_algorithms(was)
        torch.cuda.synchronize()
        runs.append(dict(counts=dict(_build.COUNTS), losses=losses,
                         gen=g.get_state(),
                         grads={n: w.grad for n, w in m.named_parameters()},
                         buffers=dict(m.named_buffers())))
    plain, rem = runs
    more = (_counts(attention_cached=12, layernorm=11, mlp_ln_res=1,
                    mlp_fc=11) if kind == "invpt" else
            _counts(window_attention=6, mlp_fc=19, layernorm=39))
    assert {k: rem["counts"][k] - v for k, v in plain["counts"].items()} \
        == more
    assert plain["counts"]["attention_bwd" if kind == "invpt"
                           else "window_attention_bwd"] > 0
    for k, v in plain["losses"].items():
        assert torch.isfinite(v) and torch.equal(v, rem["losses"][k]), k
    for n, g in plain["grads"].items():
        assert (g is None) == (rem["grads"][n] is None), n
        assert g is None or torch.equal(g, rem["grads"][n]), n
    for n, b in plain["buffers"].items():
        assert torch.equal(b, rem["buffers"][n]), n
    assert torch.equal(plain["gen"], rem["gen"])


@pytest.mark.parametrize("train", [False, True])
def test_phase_head_bf16_on_the_card_near_cpu_f32(gen, train):
    """``ConvHead(up4="phase")`` at the PASCAL head's shapes ((8, 32, 32,
    350) -> 21 logits) in bf16 on the card, eval and training, against the
    same weights and input in f32 on the CPU: relative RMS error at most
    0.03 (bf16 rounding at the conv output, the affine and the GELU, about
    2^-9 of a value each; a wiring fault gives order 1). No kernel
    launches: the phase head is torch, as it is XLA in JAX."""
    import copy

    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.heads import ConvHead
    from mtt_tpu_torch.models.layers import init_weights

    head = ConvHead(350, 21, up4="phase", device="cuda",
                    dtype=torch.bfloat16)
    init_weights(head, gen)
    with torch.no_grad():
        bn = head.mt_proj.bn
        bn.running_mean.copy_(0.1 * torch.randn(350, generator=gen,
                                                device="cuda"))
        bn.running_var.copy_(1 + 0.1 * torch.randn(
            350, generator=gen, device="cuda").abs())
    ref = copy.deepcopy(head).float().cpu()
    x = _rnd(gen, 8, 32, 32, 350)
    _build.reset_counts()
    with torch.no_grad():
        got = head(x, train=train)
        want = ref(x.float().cpu(), train=train)
    torch.cuda.synchronize()
    assert _build.COUNTS == _counts()
    assert got.shape == want.shape == (8, 128, 128, 21)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    err = ((got.float().cpu() - want).norm() / want.norm()).item()
    assert err <= 0.03, err
    if train:
        for name in ("running_mean", "running_var"):
            a, b = getattr(head.mt_proj.bn, name), getattr(ref.mt_proj.bn,
                                                          name)
            assert ((a.float().cpu() - b).norm() / b.norm()).item() <= 0.01


# ---- the kernels at the shapes past the shipped configs --------------------

@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("N", [77, 1029])
@pytest.mark.parametrize("D", [8, 16, 24, 32, 72, 80, 96, 128])
def test_attention_core_head_dims(gen, D, N, safe):
    """The attention core (rows 1-2 and 13) at head dims other than 64: in
    the 32, 64, 80 and 128 tiles, the columns past D zero; ViT-T's 16 among
    them. 4 bf16 ulps, equal bits across two runs, and under the safe
    softmax at least 99% of the outputs bit-equal to the plain version (the
    max over all keys)."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.attention import fused_attention_qkv
    B, H = 2, 4
    qkv = _rnd(gen, B, N, H * 3 * D)
    _build.reset_counts()
    got = fused_attention_qkv(qkv, H, safe=safe)
    assert _build.COUNTS == _counts(attention_qkv=1)
    want = fused_attention_qkv(qkv, H, safe=safe, impl="plain")
    _check(got, want)
    assert torch.equal(got, fused_attention_qkv(qkv, H, safe=safe))
    if safe:
        assert _bit_share(got, want) >= 0.99


@pytest.mark.parametrize("need_qkv", [False, True])
def test_attention_front_half_vit_t(gen, need_qkv):
    """Rows 1 and 2 at ViT-T's width (C 64, 4 heads of 16) over the 1025
    tokens of a 512x512 image and its cls token: LN, the projection and the
    core, each output within 4 ulps of the plain front half."""
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
    B, N, C, H = 2, 1025, 64, 4
    x = _rnd(gen, B, N, C)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=torch.float32)
    b = _rnd(gen, C, std=0.1, dtype=torch.float32)
    w = _rnd(gen, 3 * C, C, std=C ** -0.5)
    bq = _rnd(gen, 3 * C, std=0.1)
    got, want = (fused_attention_ln_qkv(x, g, b, w, bq, H, need_qkv=need_qkv,
                                        impl=impl) for impl in (None, "plain"))
    _check(got, want)


@pytest.mark.parametrize("N", [1, 65, 77, 1025])
@pytest.mark.parametrize("D", [8, 16, 32, 80, 128])
def test_attention_bwd_kernel_head_dims(gen, D, N):
    """Row 7 at head dims other than 64, in the 16, 32, 80 and 128 tiles (8
    in the 16 tile, half of it zero): dq, dk and dv each within 4 bf16 ulps
    of their own largest value, equal bits across two runs."""
    from mtt_tpu_torch.kernels.attention import (attn_core_bwd_cuda,
                                                 attn_core_bwd_plain)
    B, H = 2, 4
    qkv = _rnd(gen, B, N, H * 3 * D)
    g = _rnd(gen, B, N, H * D)
    got = attn_core_bwd_cuda(qkv, g, H, D ** -0.5)
    assert torch.equal(got, attn_core_bwd_cuda(qkv, g, H, D ** -0.5))
    got = got.view(B, N, H, 3, D)
    want = attn_core_bwd_plain(qkv, g, H, D ** -0.5).view(B, N, H, 3, D)
    _check(tuple(got[:, :, :, i] for i in range(3)),
           tuple(want[:, :, :, i] for i in range(3)))


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 4104), (3, 7, 5440), (2049, 5440),
                                   (5, 6144), (3, 8192), (4, 12008),
                                   (2, 16384)])
def test_layernorm_kernel_wide(gen, shape, param_dtype):
    """Row 3 past 4096 columns, a block of four warps a row: InvPT's
    task-merged stage norm at embed_dim 1024 (5 x 1088 = 5440) and widths
    that end inside a lane's chunks, up to the kernel's 16384. One bf16 ulp,
    as the narrow rows."""
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    C = shape[-1]
    x = _rnd(gen, *shape)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=param_dtype)
    b = _rnd(gen, C, std=0.1, dtype=param_dtype)
    _check(fused_layernorm(x, g, b), fused_layernorm(x, g, b, impl="plain"),
           ulps=1)


@pytest.mark.parametrize("C,Hd,rows", [(4104, 1024, 77), (5440, 512, 129)])
def test_mlp_ln_res_kernel_wide(gen, C, Hd, rows):
    """Row 4 past 4096 columns: its LayerNorm stage the four-warp rows, its
    GEMMs at any width that is a multiple of 8; within 4 ulps of the plain
    stages."""
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res
    args = _mlp_args(gen, rows, C, Hd, torch.bfloat16)
    _check(fused_mlp_ln_res(*args), fused_mlp_ln_res(*args, impl="plain"))


@pytest.mark.parametrize("Lq,Lk,D,with_msg,B", [
    (1024, 1024, 288, False, 1), (300, 1024, 144, True, 1),
    (1000, 1024, 72, True, 1), (70, 338, 72, True, 2),
    (33, 321, 16, False, 2), (150, 320, 544, False, 2),
    (40, 320, 488, True, 2), (20, 2000, 136, True, 1),
    (17, 10, 1024, True, 1), (9, 1023, 8, False, 2)])
def test_invpt_attention_streamed(gen, Lq, Lk, D, with_msg, B):
    """Row 9 past the resident kernel's 320 keys or head dim 480: the
    streamed form (plan rt 0), one count a call. Cityscapes-3D's 1024 keys
    at its three head dims, the smallest kv length past 320 on a square
    grid (2 x 13 x 13), head dim 544 (embed_dim 1024) and 488, 2000 keys
    (past torch's warp softmax), an odd kv length and head dims 8 and 1024.
    out 4 ulps, fused 0.01 ulps, equal bits across two runs."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.invpt_attention import (invpt_attention_plan,
                                                       invpt_fused_attention)
    assert invpt_attention_plan(B, Lq, Lk, D, with_msg)[0] == 0
    args = _invpt_inputs(gen, B, Lq, Lk, D, with_msg, heads_last=True)
    scale = (2 * D) ** -0.5
    _build.reset_counts()
    got = invpt_fused_attention(*args, scale)
    assert _build.COUNTS == _counts(invpt_attention=1)
    want = invpt_fused_attention(*args, scale, impl="plain")
    _check(got, want, ulps=(4, 0.01))
    again = invpt_fused_attention(*args, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("Lk", [1024, 2000])
def test_invpt_attention_streamed_takes_the_max_over_all_keys(gen, Lk):
    """The streamed form rounds p against the max over all keys, as the
    resident kernel: with the max mostly in a late key (the ramp of
    ``test_invpt_attention_takes_the_max_over_all_keys``) at least 99% of
    out is bit-equal to the plain version."""
    from mtt_tpu_torch.kernels.invpt_attention import (
        invpt_attention_cuda, invpt_attention_plain)
    B, Lq, D = 1, 256, 72
    q, k, v, msg, w, b = _invpt_inputs(gen, B, Lq, Lk, D, True, std=5.0)
    ramp = torch.linspace(0.2, 1.0, Lk, device="cuda")[None, None, :, None]
    k = (k.float() * ramp).to(torch.bfloat16)
    scale = (2 * D) ** -0.5
    got = invpt_attention_cuda(q, k, v, msg * 8.0, w, b, scale)
    want = invpt_attention_plain(q, k, v, msg * 8.0, w, b, scale)
    _check(got, want, ulps=(4, 0.01))
    assert _bit_share(got[0], want[0]) >= 0.99


def test_invpt_attention_plan_refuses_a_resident_plan_past_its_reach(gen):
    """A resident plan named for a shape only the streamed form takes is
    refused; chosen by the kernel, the plan is the streamed form's."""
    from mtt_tpu_torch.kernels.invpt_attention import invpt_attention_plan
    with pytest.raises(ValueError, match="no InvPT attention plan"):
        invpt_attention_plan(1, 100, 1024, 72, True, (1, 2, 4))
    assert invpt_attention_plan(1, 100, 1024, 72, True) == (0, 0, 32, 0)
    assert invpt_attention_plan(1, 100, 1024, 72, True) == (0, 0, 32, 0)


# ---- the widths JAX's models reach from a YAML -------------------------------

@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 32, 1660), (2, 64, 64, 830),
                                   (5, 7, 83), (3, 6), (4, 9, 4101),
                                   (2, 3, 5441)])
def test_layernorm_kernel_ragged_rows(gen, shape, param_dtype):
    """Rows that are not whole 16-byte chunks (InvPT's stage norms at
    embed_dim 600: 1660 and 830; odd widths in one warp and in four):
    2-byte loads, the statistics over the true width; 1 bf16 ulp."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    C = shape[-1]
    x = _rnd(gen, *shape)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=param_dtype)
    b = _rnd(gen, C, std=0.1, dtype=param_dtype)
    _build.reset_counts()
    got = fused_layernorm(x, g, b)
    assert _build.COUNTS == _counts(layernorm=1)
    _check(got, fused_layernorm(x, g, b, impl="plain"), ulps=1)


@pytest.mark.parametrize("C,Hd,rows", [(332, 1328, 45), (166, 664, 45),
                                       (83, 332, 129), (6, 24, 7)])
def test_mlp_kernels_at_padded_widths(gen, C, Hd, rows):
    """Rows 8 and 4 at widths that are not multiples of 8 (InvPT's stage
    widths at embed_dim 600, 332 and 166), zero-padded to multiples of 8:
    within 4 bf16 ulps of the plain version at the true widths, one launch
    counted each, and two runs give equal bits."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.mlp import fused_mlp, fused_mlp_ln_res
    x, g, b, w1, b1, w2, b2 = _mlp_args(gen, rows, C, Hd)
    _build.reset_counts()
    fc = fused_mlp(x, w1, b1, w2, b2)
    half = fused_mlp_ln_res(x, g, b, w1, b1, w2, b2)
    assert _build.COUNTS == _counts(mlp_fc=1, mlp_ln_res=1)
    _check(fc, fused_mlp(x, w1, b1, w2, b2, impl="plain"))
    _check(half, fused_mlp_ln_res(x, g, b, w1, b1, w2, b2, impl="plain"))
    assert torch.equal(fc, fused_mlp(x, w1, b1, w2, b2))


@pytest.mark.parametrize("D", [83, 166, 332, 6])
def test_invpt_attention_at_padded_head_dims(gen, D):
    """Row 9 at InvPT's head dims at embed_dim 600 (332, 166, 83) and at 6,
    zero-padded to multiples of 8, on the model's strided head views: out
    within 4 bf16 ulps, fused within 0.01 of the plain version."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.invpt_attention import invpt_fused_attention
    args = _invpt_inputs(gen, 2, 150, 320, D, True, heads_last=True)
    scale = (2 * D) ** -0.5
    _build.reset_counts()
    got = invpt_fused_attention(*args, scale)
    assert _build.COUNTS == _counts(invpt_attention=1)
    _check(got, invpt_fused_attention(*args, scale, impl="plain"),
           ulps=(4, 0.01))


@pytest.mark.parametrize("D", [6, 83])
def test_attention_kernels_at_padded_head_dims(gen, D):
    """Rows 1-2's core and row 13 (fast and safe), row 14 and row 7 at head
    dims that are not multiples of 8, zero-padded: 4 bf16 ulps."""
    from mtt_tpu_torch.kernels.attention import (attn_core_bwd_cuda,
                                                 attn_core_bwd_plain,
                                                 fused_attention,
                                                 fused_attention_qkv)
    H, N = 2, 77
    qkv, g = _rnd(gen, 2, N, H * 3 * D), _rnd(gen, 2, N, H * D)
    for safe in (False, True):
        _check(fused_attention_qkv(qkv, H, safe=safe),
               fused_attention_qkv(qkv, H, safe=safe, impl="plain"))
    q, k, v = _rnd(gen, 2, N, H, D), _rnd(gen, 2, 40, H, D), \
        _rnd(gen, 2, 40, H, D)
    _check(fused_attention(q, k, v), fused_attention(q, k, v, impl="plain"))
    _check(attn_core_bwd_cuda(qkv, g, H, D ** -0.5),
           attn_core_bwd_plain(qkv, g, H, D ** -0.5))


@pytest.mark.parametrize("tar,fin", [(768, 768), (13, 11), (320, 360),
                                     (304, 353)])
def test_task_decode_split_form(gen, tar, fin):
    """Row 5 past the one launch (TaskPrompter-ViT-L at tar = F = 768) and
    at tar and F it does not take (tar % 4, odd F): the split form, one
    counted call, within 4 bf16 ulps of the plain version; two runs give
    equal bits."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode
    args = _decode_args(gen, 2, 77, 256, 3, 16, tar, fin)
    _build.reset_counts()
    got = fused_task_decode(*args)
    assert _build.COUNTS == _counts(task_decode=1)
    _check(got, fused_task_decode(*args, impl="plain"))
    assert torch.equal(got, fused_task_decode(*args))
