"""The port's attention module API against the JAX package, on the CPU.

``fused_attention_qkv`` (attention over a packed head-major qkv),
``fused_attention`` (separate (B, N, H, D) q, k, v), the composed front half
``attention_ln_qkv_composed``, ``layers.Attention`` without its fused LN and
``layers.dot_product_attention``. On the CPU each wrapper runs its plain
version; the JAX side runs its Pallas kernels in interpret mode where it has
one, as tests/test_kernels.py does, and the flax modules through the JAX
package's own CPU route. Inputs come from numpy with a fixed seed, in f32.

Tolerance: rtol 1e-5 with an absolute floor of 1e-5 times the output scale,
forwards and gradients alike: the same function in f32 with sums taken in
another order (the fast softmax in exp2 form on both sides of the packed
route; the flax modules' exact softmax equals it inside the clamp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _rand(seed, *shape, s=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * s).astype(
        np.float32)


@pytest.fixture(autouse=True)
def _no_safe_env(monkeypatch):
    monkeypatch.delenv("MTT_ATTN_SAFE_SOFTMAX", raising=False)


@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("N", [40, 130])
def test_attention_qkv_matches_pallas(N, safe):
    """Row 13's plain version against the interpreted ``_attn_qkv_kernel``,
    fast and safe softmax; 2 heads of 64 (the Pallas gate's smallest)."""
    from mtt_tpu.kernels.attention import fused_attention_qkv as jax_qkv
    from mtt_tpu_torch.kernels.attention import fused_attention_qkv

    qkv = _rand(0, 2, N, 2 * 3 * 64)
    want = jax_qkv(jnp.asarray(qkv), 2, 0.125, impl="interpret", safe=safe)
    _close(fused_attention_qkv(_t(qkv), 2, 0.125, safe=safe), want)


def _online_max_attention_qkv(qkv, heads: int, scale: float, tile: int = 64):
    """Row 13's safe softmax as a streaming kernel with an ONLINE max would
    compute it, key tile by key tile: P rounded to bf16 against the running
    max, the sum and the output rescaled when the max grows. Another
    function: the TPU kernel subtracts the max over all keys first."""
    from mtt_tpu_torch.kernels.attention import scaled_log2e
    B, N, C3 = qkv.shape
    D = C3 // heads // 3
    q5 = qkv.view(B, N, heads, 3, D).transpose(1, 2)
    q = (q5[..., 0, :] * scaled_log2e(scale, qkv.dtype)).float()
    k, v = q5[..., 1, :].float(), q5[..., 2, :].float()
    m = torch.full((B, heads, N, 1), -float("inf"))
    l, o = torch.zeros(B, heads, N, 1), torch.zeros(B, heads, N, D)
    for k0 in range(0, N, tile):
        s = q @ k[:, :, k0:k0 + tile].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(qkv.dtype).float() @ v[:, :, k0:k0 + tile]
        m = m_new
    return (o / l).to(qkv.dtype).transpose(1, 2).reshape(B, N, heads * D)


def _bit_share(a, b) -> float:
    return (a.view(torch.int16) == b.view(torch.int16)).float().mean().item()


@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("N", [129, 300])
def test_attention_qkv_bf16_bits_match_pallas(N, safe):
    """Row 13's plain version in bf16 against the interpreted
    ``_attn_qkv_kernel`` on the same bf16 inputs: at least 99% of the
    outputs bit-equal (the same rounding points; f32 sums in another order
    flip a few). On the safe path a 64-key-tile online-max emulation of the
    same inputs stays under 90% (72-83% here), so the share sees a kernel
    that rounds P against a running max."""
    from mtt_tpu.kernels.attention import fused_attention_qkv as jax_qkv
    from mtt_tpu_torch.kernels.attention import fused_attention_qkv

    x = _rand(N, 1, N, 2 * 3 * 64)
    want = jax_qkv(jnp.asarray(x).astype(jnp.bfloat16), 2, 0.125,
                   impl="interpret", safe=safe)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(
        torch.bfloat16)
    qkv = _t(x).to(torch.bfloat16)
    share = _bit_share(fused_attention_qkv(qkv, 2, 0.125, safe=safe), want)
    assert share >= 0.99, share
    if safe:
        online = _bit_share(_online_max_attention_qkv(qkv, 2, 0.125), want)
        assert online < 0.9, online


def test_attention_qkv_grad_matches_jax():
    """The backward is JAX's custom VJP ``_qkv_bwd``: dqkv against
    ``jax.grad`` of <out, g>."""
    from mtt_tpu.kernels.attention import fused_attention_qkv as jax_qkv
    from mtt_tpu_torch.kernels.attention import fused_attention_qkv

    qkv, g = _rand(1, 2, 77, 2 * 3 * 64), _rand(2, 2, 77, 2 * 64)
    want = jax.grad(lambda a: (jax_qkv(a, 2, 0.125, impl="interpret")
                               * jnp.asarray(g)).sum())(jnp.asarray(qkv))
    x = _t(qkv, grad=True)
    (fused_attention_qkv(x, 2, 0.125) * _t(g)).sum().backward()
    _close(x.grad, want)


@pytest.mark.parametrize("Nq,Nk,D", [(40, 40, 64), (130, 130, 64),
                                     (100, 37, 72)])
def test_attention_generic_matches_pallas(Nq, Nk, D):
    """Row 14's plain version against the interpreted ``_attn_kernel``:
    self-attention and a cross shape with Nq != Nk and D = 72 (InvPT's head
    dim); logits large enough that the max subtraction matters."""
    from mtt_tpu.kernels.attention import fused_attention as jax_attn
    from mtt_tpu_torch.kernels.attention import fused_attention

    q, k, v = _rand(3, 2, Nq, 2, D, s=3.0), _rand(4, 2, Nk, 2, D, s=3.0), \
        _rand(5, 2, Nk, 2, D)
    want = jax_attn(*map(jnp.asarray, (q, k, v)), impl="interpret")
    _close(fused_attention(_t(q), _t(k), _t(v)), want)


def test_attention_generic_grad_matches_jax():
    """The backward is JAX's custom VJP ``_bwd``: dq, dk, dv against
    ``jax.grad``, Nq != Nk."""
    from mtt_tpu.kernels.attention import fused_attention as jax_attn
    from mtt_tpu_torch.kernels.attention import fused_attention

    q, k, v = _rand(6, 2, 50, 2, 64), _rand(7, 2, 33, 2, 64), \
        _rand(8, 2, 33, 2, 64)
    g = _rand(9, 2, 50, 2, 64)
    want = jax.grad(lambda *a: (jax_attn(*a, impl="xla")
                                * jnp.asarray(g)).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [_t(a, grad=True) for a in (q, k, v)]
    (fused_attention(*ts) * _t(g)).sum().backward()
    for t, w in zip(ts, want):
        _close(t.grad, w)


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("safe", [False, True])
def test_attention_ln_qkv_composed_matches_xla(emit, safe):
    """The composed front half against ``_attn_ln_qkv_xla`` with the
    interpreted qkv kernel inside, as the TPU takes it when ``_attn_ln_ok``
    refuses a shape; the tap variant's qkv and LN(x) too."""
    from mtt_tpu.kernels.attention import _attn_ln_qkv_xla
    from mtt_tpu_torch.kernels.attention import attention_ln_qkv_composed

    B, N, H, D = 2, 45, 2, 64
    C = H * D
    x = _rand(10, B, N, C)
    g, b = 1.0 + _rand(11, C, s=0.1), _rand(12, C, s=0.1)
    w, bq = _rand(13, C, 3 * C, s=0.05), _rand(14, 3 * C, s=0.05)
    want = _attn_ln_qkv_xla(*map(jnp.asarray, (x, g, b, w, bq)), H,
                            D ** -0.5, 1e-6, emit, sub_impl="interpret",
                            safe=safe)
    got = attention_ln_qkv_composed(_t(x), _t(g), _t(b), _t(w.T), _t(bq), H,
                                    need_qkv=emit, safe=safe)
    for gv, wv in zip(got if emit else (got,), want if emit else (want,)):
        _close(gv, wv)


@pytest.mark.parametrize("train", [False, True])
def test_attention_module_without_ln_matches_flax(train):
    """``layers.Attention`` called without ``ln`` against the flax
    ``Attention`` on the same weights carried by ``state_dict_from_flax``
    (strict load): the output and the gradient of the input; ``train``
    is the flax module's ``deterministic=False`` (the safe softmax)."""
    from mtt_tpu.models.layers import Attention as JAttention
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.models.layers import Attention

    x, g = _rand(15, 2, 29, 128), _rand(16, 2, 29, 128)
    jm = JAttention(num_heads=2)
    v = random_variables(jm, jnp.asarray(x), seed=17)

    def jf(a):
        return jm.apply(v, a, deterministic=not train)

    want = jf(jnp.asarray(x))
    want_dx = jax.grad(lambda a: (jf(a) * jnp.asarray(g)).sum())(
        jnp.asarray(x))
    port = Attention(128, 2, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    xt = _t(x, grad=True)
    out = port(xt, train=train)
    _close(out, want)
    (out * _t(g)).sum().backward()
    _close(xt.grad, want_dx)


def test_dot_product_attention_matches_jax():
    from mtt_tpu.models.layers import dot_product_attention as jax_dpa
    from mtt_tpu_torch.models.layers import dot_product_attention

    q, k, v = _rand(18, 2, 21, 3, 16), _rand(19, 2, 34, 3, 16), \
        _rand(20, 2, 34, 3, 16)
    _close(dot_product_attention(_t(q), _t(k), _t(v), scale=0.3),
           jax_dpa(*map(jnp.asarray, (q, k, v)), scale=0.3))


def test_kernel_paths_refuse_what_the_kernels_do_not_take():
    """The card's entry points check before any launch, so the refusals show
    on the CPU: row 13 takes bf16 or f32 (no other dtype), a contiguous qkv
    and head dims up to 128 (ViT-T has 16); row 14 bf16 or f32, head dims up
    to 128 and aligned strides; both raise on a request for the kernel with
    a CPU tensor. A head dim that is not a multiple of 8 reaches the kernel
    zero-padded to one."""
    from mtt_tpu_torch.kernels.attention import (attention_generic_cuda,
                                                 attention_generic_padded,
                                                 attn_core_cuda,
                                                 check_attn_head_dim,
                                                 fused_attention,
                                                 fused_attention_qkv)
    bf = torch.bfloat16
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        attn_core_cuda(torch.zeros(1, 5, 384, dtype=torch.float16), 2, 0.125,
                       False)
    with pytest.raises(ValueError, match="contiguous"):
        attn_core_cuda(torch.zeros(1, 384, 5, dtype=bf).transpose(1, 2),
                           2, 0.125, False)
    check_attn_head_dim(32, "row 13")
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 128"):
        attn_core_cuda(torch.zeros(1, 5, 816, dtype=bf), 2, 0.125, False)
    with pytest.raises(ValueError, match="H\\*3\\*D"):
        fused_attention_qkv(torch.zeros(1, 5, 100), 3)
    q = torch.zeros(1, 5, 2, 72, dtype=bf)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        attention_generic_cuda(q.half(), q.half(), q.half(), 0.1)
    seen = []

    def launch(q, k, v, scale):
        seen.append((q.shape[-1], q.is_contiguous()))
        return torch.zeros_like(q)

    out = attention_generic_padded(q[..., :12], q[..., :12], q[..., :12],
                                   0.1, launch)
    assert out.shape == (1, 5, 2, 12) and seen == [(16, True)]
    with pytest.raises(ValueError, match="multiples of 8"):
        z = torch.zeros(1, 5, 2, 136, dtype=bf)
        attention_generic_cuda(z, z, z, 0.1)
    odd = torch.zeros(1, 5, 2, 76, dtype=bf)[:, :, :, :72]   # head stride 76
    with pytest.raises(ValueError, match="strides"):
        attention_generic_cuda(odd, odd.contiguous(), odd.contiguous(), 0.1)
    with pytest.raises(ValueError, match="Nk"):
        fused_attention(q, q[:, :, :1], q)
    for call in (lambda: fused_attention(q, q, q, impl="cuda"),
                 lambda: fused_attention_qkv(torch.zeros(1, 5, 384), 2,
                                             impl="cuda")):
        with pytest.raises(ValueError, match="CUDA"):
            call()
