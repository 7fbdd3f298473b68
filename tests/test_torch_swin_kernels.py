"""The Swin path's kernels on the CPU: the window attention's plain version
against the JAX package's ``fused_window_attention`` (the Pallas kernel in
interpret mode, and its XLA composition), and the plain MLP and LayerNorm at
the shapes the Swin blocks give them.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances: f32 at 1e-5 of the output's scale (the same function with sums in
another order); bf16 against the interpreted Pallas kernel at 1 bf16 ulp of
the largest output (the plain version rounds where the kernel rounds: p to
bf16 before p.v, one division by the f32 row sum after), against the XLA
composition at 2 ulps (it normalises p before rounding it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_threads import torch_threads  # noqa: F401

BF16_ULP = 2.0 ** -7


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _inputs(seed, BW, M, H, D, nW):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(BW, M, H, D)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(H, M, M)).astype(np.float32)
    mask = np.where(rng.random((nW, M, M)) < 0.3, -100.0, 0.0
                    ).astype(np.float32)
    for w in range(nW):                  # no row is masked out entirely
        np.fill_diagonal(mask[w], 0.0)
    return q, k, v, bias, mask


CASES = [  # BW, M, H, D, nW
    (8, 19, 2, 32, 4),        # a 4x4 window with 3 prompts; nW < BW
    (4, 147, 2, 32, 2),       # Swin-B's 12x12 window with 3 prompts
    (3, 7, 1, 32, 3),         # nW == BW, a tiny window
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("jimpl", ["interpret", "xla"])
def test_window_attention_plain_matches_jax(case, with_mask, jimpl):
    from mtt_tpu.kernels.attention import fused_window_attention as jwattn
    from mtt_tpu_torch.kernels.window_attention import (
        fused_window_attention, window_attention_plain)
    BW, M, H, D, nW = case
    q, k, v, bias, mask = _inputs(0, BW, M, H, D, nW)
    scale = D ** -0.5
    jm = jnp.asarray(mask) if with_mask else None
    tm = _t(mask) if with_mask else None

    want = np.asarray(jwattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(bias), jm, scale, nW, impl=jimpl))
    got = fused_window_attention(_t(q), _t(k), _t(v), _t(bias), tm, scale,
                                 nW)
    assert got.shape == (BW, M, H, D) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # a CPU tensor takes the plain version, and only it
    assert torch.equal(got, window_attention_plain(
        _t(q), _t(k), _t(v), _t(bias), tm, scale, nW))

    bf = jnp.bfloat16
    want = np.asarray(jwattn(jnp.asarray(q, bf), jnp.asarray(k, bf),
                             jnp.asarray(v, bf), jnp.asarray(bias), jm, scale,
                             nW, impl=jimpl).astype(jnp.float32))
    tb = torch.bfloat16
    got = fused_window_attention(_t(q, tb), _t(k, tb), _t(v, tb), _t(bias),
                                 tm, scale, nW)
    assert got.dtype == tb
    ulps = 1 if jimpl == "interpret" else 2
    err = np.abs(got.float().numpy() - want).max()
    assert err <= ulps * BF16_ULP * np.abs(want).max(), err


def test_window_attention_masked_keys_lose_all_probability():
    """A key masked with -100 for every query of a window contributes
    nothing: changing its value row changes no output."""
    from mtt_tpu_torch.kernels.window_attention import fused_window_attention
    BW, M, H, D, nW = 4, 19, 2, 32, 2
    q, k, v, bias, _ = _inputs(1, BW, M, H, D, nW)
    mask = np.zeros((nW, M, M), np.float32)
    mask[:, :, 5] = -100.0
    out = fused_window_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask),
                                 D ** -0.5, nW)
    v2 = v.copy()
    v2[:, 5] += 1000.0
    out2 = fused_window_attention(_t(q), _t(k), _t(v2), _t(bias), _t(mask),
                                  D ** -0.5, nW)
    assert (out - out2).abs().max() <= 1e-5 * out.abs().max()


def test_window_attention_reads_packed_qkv_views():
    """q, k and v as strided views of one packed (BW, M, 3, H, D) projection
    give what contiguous copies give."""
    from mtt_tpu_torch.kernels.window_attention import fused_window_attention
    BW, M, H, D, nW = 4, 19, 2, 32, 2
    rng = np.random.default_rng(2)
    qkv = _t(rng.normal(size=(BW, M, 3, H, D)).astype(np.float32))
    _, _, _, bias, mask = _inputs(2, BW, M, H, D, nW)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    a = fused_window_attention(q, k, v, _t(bias), _t(mask), 0.2, nW)
    b = fused_window_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               _t(bias), _t(mask), 0.2, nW)
    assert torch.equal(a, b)


def test_window_attention_refusals():
    from mtt_tpu_torch.kernels.window_attention import (
        check_window_attention_shape, fused_window_attention,
        window_attention_bwd_cuda, window_attention_cuda)
    BW, M, H, D, nW = 4, 19, 2, 32, 2
    q, k, v, bias, mask = (_t(a) for a in _inputs(0, BW, M, H, D, nW))
    with pytest.raises(ValueError, match="CUDA"):      # no card behind it
        fused_window_attention(q, k, v, bias, mask, 0.2, nW, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        fused_window_attention(q, k, v, bias, mask, 0.2, nW, impl="xla")
    with pytest.raises(ValueError, match="bias"):
        fused_window_attention(q, k, v, bias[:, :-1], mask, 0.2, nW)
    with pytest.raises(ValueError, match="mask"):
        fused_window_attention(q, k, v, bias, mask, 0.2, 3)   # 4 % 3
    with pytest.raises(ValueError, match="shape"):
        fused_window_attention(q, k[:, :-1], v, bias, mask, 0.2, nW)
    with pytest.raises(TypeError, match="dtype"):
        fused_window_attention(q, k.double(), v, bias, mask, 0.2, nW)
    # the kernel itself: bfloat16 and head dim 32 only
    with pytest.raises(TypeError, match="bfloat16"):
        window_attention_cuda(q, k, v, bias, mask, 0.2, nW)
    q64 = torch.zeros(BW, M, H, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 32"):
        window_attention_cuda(q64, q64, q64, bias, mask, 0.2, nW)
    # the forward takes any token count (past 160 a window over streamed
    # keys); the backward keeps a window in shared memory and refuses past
    # 160 before a launch
    big = torch.zeros(1, 400, 1, 32, dtype=torch.bfloat16)
    check_window_attention_shape(400, 32)
    with pytest.raises(ValueError, match="shared memory"):
        window_attention_bwd_cuda(big, big, big, torch.zeros(1, 400, 400),
                                  None, big, 0.2, 1)


def test_window_attention_plain_is_differentiable():
    """On a CPU tensor the gradient is the plain backward's, through the
    autograd Function: it flows to q, k, v and the bias."""
    from mtt_tpu_torch.kernels.window_attention import fused_window_attention
    BW, M, H, D, nW = 2, 7, 1, 32, 2
    q, k, v, bias, mask = (_t(a) for a in _inputs(3, BW, M, H, D, nW))
    leaves = [t.requires_grad_() for t in (q, k, v, bias)]
    fused_window_attention(*leaves, mask, 0.2, nW).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               and t.grad.abs().sum() > 0 for t in leaves)


BWD_CASES = [  # BW, M, H, D, nW: Swin-B's 12x12 window with 3 prompts,
    (4, 147, 2, 32, 2),       # M % 16 != 0, nW < BW
]


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("with_mask", [True, False])
def test_window_attention_bwd_plain_matches_jax(case, with_mask):
    """``window_attention_bwd_plain`` against the TPU backward kernel
    (``_wattn_bwd_pallas`` in interpret mode) in bf16, and the gradient of the
    autograd Function in f32 against ``jax.grad`` of ``_window_attention_xla``.

    bf16: dq, dk and dv within 2 ulps of their largest value (the same
    rounding points, f32 sums in another order can flip one); dbias (f32 on
    both sides, the same dl summed over the windows in another order) within
    1e-5 of its largest value. f32: 1e-5 of each gradient's scale."""
    import jax
    from mtt_tpu.kernels.attention import _wattn_bwd_pallas, \
        _window_attention_xla
    from mtt_tpu_torch.kernels.window_attention import (
        fused_window_attention_qkv, window_attention_bwd_plain)
    BW, M, H, D, nW = case
    q, k, v, bias, mask = _inputs(4, BW, M, H, D, nW)
    g = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    scale = D ** -0.5
    bf = jnp.bfloat16
    jm = jnp.asarray(mask) if with_mask else jnp.zeros((1, M, M),
                                                       jnp.float32)
    want = _wattn_bwd_pallas(*(jnp.asarray(a, bf) for a in (q, k, v)),
                             jnp.asarray(bias), jm, jnp.asarray(g, bf),
                             scale, nW if with_mask else 1, interpret=True)
    tb = torch.bfloat16
    got = window_attention_bwd_plain(
        _t(q, tb), _t(k, tb), _t(v, tb), _t(bias),
        _t(mask) if with_mask else None, _t(g, tb), scale, nW)
    for name, gt, wt in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        wt = np.asarray(wt.astype(jnp.float32))
        assert gt.dtype == tb
        err = np.abs(gt.float().numpy() - wt).max()
        assert err <= 2 * BF16_ULP * np.abs(wt).max(), (name, err)
    wdb = np.asarray(want[3])
    assert got[3].dtype == torch.float32 and got[3].shape == (H, M, M)
    assert np.abs(got[3].numpy() - wdb).max() <= 1e-5 * np.abs(wdb).max()

    # f32: the Function's gradient against jax.grad of the XLA twin
    jmask = jnp.asarray(mask) if with_mask else None
    jgrads = jax.grad(
        lambda qq, kk, vv, bb: jnp.sum(_window_attention_xla(
            qq, kk, vv, bb, jmask, scale, nW) * jnp.asarray(g)),
        argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))
    qkv = torch.stack([_t(a) for a in (q, k, v)], 2).requires_grad_()
    tbias = _t(bias).requires_grad_()
    out = fused_window_attention_qkv(qkv, tbias,
                                     _t(mask) if with_mask else None, scale,
                                     nW)
    out.backward(_t(g))
    for name, gt, wt in zip(("dq", "dk", "dv", "dbias"),
                            (*qkv.grad.unbind(2), tbias.grad), jgrads):
        wt = np.asarray(wt)
        err = np.abs(gt.numpy() - wt).max()
        assert err <= 1e-5 * np.abs(wt).max(), (name, err)


@pytest.mark.parametrize("C", [128, 256, 512])
@pytest.mark.parametrize("rows", [(1, 3), (2, 45)])
def test_mlp_plain_matches_jax_at_swin_widths(C, rows):
    """``fused_mlp`` at the Swin-B stage widths, on the 3 prompt rows and on
    a patch-row count that is no multiple of the GEMM's 64- or 128-row
    tiles."""
    from mtt_tpu.kernels.mlp import fused_mlp as jmlp
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    rng = np.random.default_rng(C)
    Hd = 4 * C
    x = rng.normal(size=(*rows, C)).astype(np.float32)
    w1 = (rng.normal(size=(C, Hd)) * C ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(Hd,))).astype(np.float32)
    w2 = (rng.normal(size=(Hd, C)) * Hd ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(C,))).astype(np.float32)
    want = np.asarray(jmlp(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                           impl="interpret"))
    got = fused_mlp(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(1, 3, 128), (2, 50, 256), (1, 9, 2048)])
def test_layernorm_plain_matches_jax_at_swin_eps(shape):
    """eps 1e-5 (every Swin norm), from the 3 prompt rows to PatchMerging's
    4C rows."""
    from mtt_tpu.kernels.layernorm import fused_layernorm as jln
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    rng = np.random.default_rng(shape[-1])
    x = (0.01 * rng.normal(size=shape)).astype(np.float32)   # eps matters
    g = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    b = (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    want = np.asarray(jln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          1e-5))
    got = fused_layernorm(_t(x), _t(g), _t(b), 1e-5).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    other = fused_layernorm(_t(x), _t(g), _t(b), 1e-6).numpy()
    assert np.abs(other - want).max() > 1e-3 * np.abs(want).max()
