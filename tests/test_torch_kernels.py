"""The PyTorch port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of mtt_tpu_torch runs its plain version (the CUDA
kernels run only on the card: tests/test_torch_cuda.py, chip_smoke.py). The
JAX side runs its Pallas kernels in interpret mode, as tests/test_kernels.py
does. Inputs come from numpy with a fixed seed; everything is f32, so the two
sides agree to f32 rounding: rtol 1e-5 and an absolute floor of 1e-5 times
the output scale (sums taken in another order; the port's GELU is the same
A&S polynomial, its softmax the same exp2 form).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_threads import torch_threads  # noqa: F401


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ln_inputs(rng, shape):
    C = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=(C,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(C,))).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("shape", [(2, 56, 128), (3, 7, 256)])
def test_layernorm_matches_pallas(shape):
    from mtt_tpu.kernels.layernorm import fused_layernorm as jax_ln
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm

    x, g, b = _ln_inputs(np.random.default_rng(0), shape)
    want = jax_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                  impl="interpret")
    _close(fused_layernorm(_t(x), _t(g), _t(b)), want)


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("safe", [False, True])
def test_attention_ln_qkv_matches_pallas(emit, safe, monkeypatch):
    """Cached (non-tap) and emit (tap) variants, fast and safe softmax.
    Smallest shapes the Pallas gate admits: C=128, 2 heads of 64."""
    monkeypatch.delenv("MTT_ATTN_SAFE_SOFTMAX", raising=False)
    from mtt_tpu.kernels.attention import fused_attention_ln_qkv as jax_attn
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv

    rng = np.random.default_rng(1)
    B, N, H, D = 2, 56, 2, 64
    C = H * D
    x, g, b = _ln_inputs(rng, (B, N, C))
    w = (rng.normal(size=(C, 3 * C)) * 0.05).astype(np.float32)
    bq = (rng.normal(size=(3 * C,)) * 0.05).astype(np.float32)
    want = jax_attn(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                    jnp.asarray(w), jnp.asarray(bq), H, need_qkv=emit,
                    impl="interpret", safe=safe)
    got = fused_attention_ln_qkv(_t(x), _t(g), _t(b), _t(w.T), _t(bq), H,
                                 need_qkv=emit, safe=safe)
    if emit:
        assert len(got) == len(want) == 3
        for gv, wv in zip(got, want):
            _close(gv, wv)
    else:
        _close(got, want)


def test_mlp_ln_res_matches_pallas():
    from mtt_tpu.kernels.mlp import fused_mlp_ln_res as jax_mlp
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res

    rng = np.random.default_rng(2)
    C, Hd = 128, 512
    x, g, b = _ln_inputs(rng, (2, 56, C))
    w1 = (rng.normal(size=(C, Hd)) * 0.05).astype(np.float32)
    b1 = (rng.normal(size=(Hd,)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(Hd, C)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(C,)) * 0.05).astype(np.float32)
    want = jax_mlp(*map(jnp.asarray, (x, g, b, w1, b1, w2, b2)),
                   impl="interpret")
    got = fused_mlp_ln_res(_t(x), _t(g), _t(b), _t(w1.T), _t(b1), _t(w2.T),
                           _t(b2))
    _close(got, want)


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_mlp_ln_res_plain_stages_keep_the_one_piece_bits(param_dtype):
    """The plain half-block as the kernel's three stages (LayerNorm, fc1 +
    b1 + GELU, fc2 + b2 + x) gives the bits of the one-piece formula it
    replaced, at ViT-T width (C 192, hidden 768) in bf16, with f32 and with
    bf16 parameters; the plain MLP alone, as two of those stages, likewise."""
    import torch.nn.functional as F

    from mtt_tpu_torch.kernels.layernorm import layernorm_plain
    from mtt_tpu_torch.kernels.mlp import (gelu_erf_poly, mlp_fc1_gelu_plain,
                                           mlp_fc2_plain, mlp_fc_plain,
                                           mlp_ln_res_plain)

    rng = np.random.default_rng(7)
    C, Hd, bf = 192, 768, torch.bfloat16
    x, g, b = (_t(a) for a in _ln_inputs(rng, (2, 17, C)))
    x, g, b = x.to(bf), g.to(param_dtype), b.to(param_dtype)
    w1 = _t(rng.normal(size=(Hd, C)) * C ** -0.5).to(bf)
    w2 = _t(rng.normal(size=(C, Hd)) * Hd ** -0.5).to(bf)
    b1 = _t(rng.normal(size=(Hd,)) * 0.1).to(param_dtype)
    b2 = _t(rng.normal(size=(C,)) * 0.1).to(param_dtype)

    xn = layernorm_plain(x, g, b)
    a = gelu_erf_poly(F.linear(xn.float(), w1.float()) + b1.float()).to(bf)
    want = (F.linear(a.float(), w2.float()) + b2.float() + x.float()).to(bf)
    stages = mlp_fc2_plain(mlp_fc1_gelu_plain(xn, w1, b1), w2, b2, res=x)
    assert torch.equal(stages, want)
    assert torch.equal(mlp_ln_res_plain(x, g, b, w1, b1, w2, b2), want)
    a = gelu_erf_poly(F.linear(x.float(), w1.float()) + b1.float()).to(bf)
    want_fc = (F.linear(a.float(), w2.float()) + b2.float()).to(bf)
    assert torch.equal(mlp_fc_plain(x, w1, b1, w2, b2), want_fc)


def test_mlp_matches_pallas_at_vit_t_width():
    """The plain MLP (row 8) at ViT-T's C = 192, hidden 768, a width its old
    kernel refused (the JAX wrapper zero-pads both to multiples of 128 for
    its tiling, which leaves the function as it is), on 3 x 37 rows."""
    from mtt_tpu.kernels.mlp import fused_mlp as jax_mlp
    from mtt_tpu_torch.kernels.mlp import fused_mlp

    rng = np.random.default_rng(11)
    C, Hd = 192, 768
    x = rng.normal(size=(3, 37, C)).astype(np.float32)
    w1 = (rng.normal(size=(C, Hd)) * C ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=(Hd,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(Hd, C)) * Hd ** -0.5).astype(np.float32)
    b2 = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    want = jax_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2)), impl="interpret")
    _close(fused_mlp(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2)), want)


def test_qkv_proj_plain_matches_the_emit_kernel_at_vit_t():
    """The projection stage of rows 1-2 (``qkv_proj_plain``, the function of
    the shared GEMM's bias launch) against the qkv that the JAX emit kernel
    (``_attn_ln_qkv_kernel``, ln=False, emit=True) returns in interpret mode
    at ViT-T: C = 192, 3 heads of 64, so 3C = 576, which the old CUDA
    projection refused. The public JAX wrapper's Pallas gate wants C % 128
    == 0 and an even head count, so the kernel is called with one head a
    block. bf16 in and out; both sum the products in f32, add the bias and
    round once, so they differ only where a sum in another order flips that
    rounding: at most 1 bf16 ulp of the largest value."""
    from mtt_tpu.kernels.attention import _attn_ln_qkv_pallas
    from mtt_tpu_torch.kernels.attention import qkv_proj_plain

    rng = np.random.default_rng(12)
    B, N, H, D = 2, 37, 3, 64
    C = H * D
    bf = torch.bfloat16
    xn = _t(rng.normal(size=(B, N, C)).astype(np.float32)).to(bf)
    w = _t((rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(np.float32)
           ).to(bf)
    b = _t((rng.normal(size=(3 * C,)) * 0.1).astype(np.float32)).to(bf)

    def jx(t):
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)

    _, want = _attn_ln_qkv_pallas(jx(xn), jnp.ones(C), jnp.zeros(C), jx(w),
                                  jx(b), H, D ** -0.5, 1e-6, hpb=1, ln=False,
                                  emit=True, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = qkv_proj_plain(xn, w.t().contiguous(), b)
    assert got.dtype == bf and got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -7 * np.abs(want).max(), err


def test_task_decode_matches_pallas():
    """tar and final not multiples of 16, as the model's 300 / 350."""
    from mtt_tpu.kernels.task_decode import fused_task_decode as jax_dec
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode

    rng = np.random.default_rng(3)
    B, S, C, T, G, tar, fin = 2, 128, 128, 3, 4, 20, 28

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    x, a, cw = r(B, S, C), r(B, T, S, G), r(B, T, C)
    ws, wc, wf = r(T, C, tar, s=0.05), r(T, C, tar, s=0.05), \
        r(T, 2 * tar, fin, s=0.05)
    bs, bc, bf = r(T, tar, s=0.05), r(T, tar, s=0.05), r(T, fin, s=0.05)
    want = jax_dec(*map(jnp.asarray, (x, a, cw, ws, bs, wc, bc, wf, bf)),
                   impl="interpret")
    got = fused_task_decode(
        _t(x), _t(a), _t(cw), _t(ws.transpose(0, 2, 1)), _t(bs),
        _t(wc.transpose(0, 2, 1)), _t(bc), _t(wf.transpose(0, 2, 1)), _t(bf))
    _close(got, want)


def test_gelu_erf_poly_matches_jax():
    from mtt_tpu.kernels.mlp import _gelu_erf_poly
    from mtt_tpu_torch.kernels.mlp import gelu_erf_poly

    h = np.linspace(-8, 8, 4097, dtype=np.float32)
    _close(gelu_erf_poly(_t(h)), _gelu_erf_poly(jnp.asarray(h)), rtol=2e-6)


@pytest.mark.parametrize("safe", [False, True])
def test_exp2_probs_match_jax(safe):
    """Includes logits past both clamps of the fast path."""
    from mtt_tpu.kernels.attention import _fast_exp2_probs
    from mtt_tpu_torch.kernels.attention import fast_exp2_probs

    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 67)) * 60).astype(np.float32)
    want = _fast_exp2_probs(jnp.asarray(logits), safe, 67)
    got = fast_exp2_probs(_t(logits), safe, 67)
    # compare the normalised rows: raw values span 2^-120 .. 2^119
    want = np.asarray(want) / np.asarray(want).sum(-1, keepdims=True)
    got = (got / got.sum(-1, keepdim=True)).numpy()
    assert np.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("env,safe", [(None, False), (None, True),
                                      ("0", True), ("1", False), ("", True)])
def test_resolve_safe_matches_jax(env, safe, monkeypatch):
    from mtt_tpu.kernels.attention import _resolve_safe
    from mtt_tpu_torch.kernels.attention import resolve_safe

    if env is None:
        monkeypatch.delenv("MTT_ATTN_SAFE_SOFTMAX", raising=False)
    else:
        monkeypatch.setenv("MTT_ATTN_SAFE_SOFTMAX", env)
    assert resolve_safe(safe) == _resolve_safe(safe)
