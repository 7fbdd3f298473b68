"""The port's kernel gradients and its plain MLP against the JAX package, on
the CPU, in f32.

Each autograd Function of mtt_tpu_torch/kernels runs its plain forward here
and the same backward code it runs on the card (only the attention-core
backward has a kernel, whose plain twin runs here). The JAX side takes
``jax.grad`` through its custom VJPs, with its Pallas kernels in interpret
mode where the JAX tests run them so. Inputs and cotangents come from numpy
with a fixed seed. Tolerance: rtol 1e-4 with an absolute floor of 1e-5 times
each gradient's largest value (both sides run the same f32 math with sums in
another order; the attention backward of JAX on the CPU differentiates its
exp-softmax composition where the port runs the hand-written backward).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_threads import torch_threads  # noqa: F401


def _close(got, want, rtol=1e-4, floor=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-30))


def _r(rng, *shape, s=1.0, mean=0.0):
    return (mean + s * rng.normal(size=shape)).astype(np.float32)


def _port_grads(fn, arrays, cots):
    """Gradients of sum(out_i * cot_i) w.r.t. every array, through the port."""
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ins)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cots])
    return [t.grad for t in ins]


def _jax_grads(fn, arrays, cots):
    def loss(*a):
        out = fn(*a)
        out = out if isinstance(out, tuple) else (out,)
        return sum((o * c).sum() for o, c in zip(out, cots))
    return jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))


def test_attn_core_bwd_plain_matches_pallas_and_xla():
    """The plain twin of the attention-core backward kernel against
    _attn_core_bwd_pallas (interpret) and _attn_core_bwd_xla, at the shapes
    of tests/test_kernels.py:test_attn_core_bwd_pallas_matches_xla and its
    tolerance (2e-4)."""
    from mtt_tpu.kernels.attention import (_attn_core_bwd_pallas,
                                           _attn_core_bwd_xla)
    from mtt_tpu_torch.kernels.attention import attn_core_bwd_plain
    rng = np.random.default_rng(3)
    B, N, H, D = 2, 100, 4, 64
    qkv, g = _r(rng, B, N, H * 3 * D), _r(rng, B, N, H * D)
    got = attn_core_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(g), H,
                              D ** -0.5).numpy()
    for want in (_attn_core_bwd_pallas(jnp.asarray(qkv), jnp.asarray(g), H,
                                       D ** -0.5, interpret=True),
                 _attn_core_bwd_xla(jnp.asarray(qkv), jnp.asarray(g), H,
                                    D ** -0.5)):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("emit", [False, True])
def test_attention_ln_qkv_grads_match_jax(emit):
    """The whole fused_attention_ln_qkv Function, cached and emit (whose qkv
    and xn outputs carry cotangents too), safe softmax as in training."""
    from mtt_tpu.kernels.attention import fused_attention_ln_qkv as jax_attn
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
    rng = np.random.default_rng(4)
    B, N, H, D = 2, 37, 2, 64
    C = H * D
    arrays = [_r(rng, B, N, C), _r(rng, C, s=0.1, mean=1.0),
              _r(rng, C, s=0.1), _r(rng, C, 3 * C, s=0.05),
              _r(rng, 3 * C, s=0.05)]
    cots = [_r(rng, B, N, C), _r(rng, B, N, 3 * C), _r(rng, B, N, C)]
    cots = cots if emit else cots[:1]
    want = _jax_grads(lambda x, g, b, w, bq: jax_attn(
        x, g, b, w, bq, H, need_qkv=emit, impl="xla", safe=True),
        arrays, cots)
    got = _port_grads(lambda x, g, b, w, bq: fused_attention_ln_qkv(
        x, g, b, w.t().contiguous(), bq, H, need_qkv=emit, safe=True),
        arrays, cots)
    for a, b in zip(got, want):
        _close(a, b)


def test_mlp_fc_plain_matches_pallas():
    """mlp_fc_plain against fused_mlp's Pallas kernel in interpret mode
    (tests/test_kernels.py:136), f32: both use the A&S erf, rtol 1e-5 with
    a 1e-5 floor of the output scale."""
    from mtt_tpu.kernels.mlp import fused_mlp as jax_mlp
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    rng = np.random.default_rng(6)
    C, Hd = 128, 512
    x = _r(rng, 2, 50, C)
    w1, b1 = _r(rng, C, Hd, s=0.05), _r(rng, Hd, s=0.05)
    w2, b2 = _r(rng, Hd, C, s=0.05), _r(rng, C, s=0.05)
    want = jax_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2)), impl="interpret")
    got = fused_mlp(*[torch.from_numpy(np.ascontiguousarray(a))
                      for a in (x, w1.T, b1, w2.T, b2)])
    _close(got, want, rtol=1e-5)


def test_mlp_fc_grads_match_jax():
    """fused_mlp's hand-written f32 backward (mlp.py:201-222)."""
    from mtt_tpu.kernels.mlp import fused_mlp as jax_mlp
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    rng = np.random.default_rng(7)
    C, Hd = 64, 256
    arrays = [_r(rng, 2, 9, C), _r(rng, C, Hd, s=0.1), _r(rng, Hd, s=0.1),
              _r(rng, Hd, C, s=0.1), _r(rng, C, s=0.1)]
    cots = [_r(rng, 2, 9, C)]
    want = _jax_grads(lambda *a: jax_mlp(*a, impl="xla"), arrays, cots)
    got = _port_grads(lambda x, w1, b1, w2, b2: fused_mlp(
        x, w1.t().contiguous(), b1, w2.t().contiguous(), b2), arrays, cots)
    for a, b in zip(got, want):
        _close(a, b)


def test_mlp_ln_res_grads_match_jax():
    """fused_mlp_ln_res's hand-written backward (mlp.py:499-540)."""
    from mtt_tpu.kernels.mlp import fused_mlp_ln_res as jax_mlp
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res
    rng = np.random.default_rng(8)
    C, Hd = 64, 256
    arrays = [_r(rng, 2, 9, C), _r(rng, C, s=0.1, mean=1.0),
              _r(rng, C, s=0.1), _r(rng, C, Hd, s=0.1), _r(rng, Hd, s=0.1),
              _r(rng, Hd, C, s=0.1), _r(rng, C, s=0.1)]
    cots = [_r(rng, 2, 9, C)]
    want = _jax_grads(lambda *a: jax_mlp(*a, impl="xla"), arrays, cots)
    got = _port_grads(lambda x, g, b, w1, b1, w2, b2: fused_mlp_ln_res(
        x, g, b, w1.t().contiguous(), b1, w2.t().contiguous(), b2),
        arrays, cots)
    for a, b in zip(got, want):
        _close(a, b)


def test_layernorm_grads_match_jax():
    """fused_layernorm's f32 recompute backward (layernorm.py:89-106)."""
    from mtt_tpu.kernels.layernorm import fused_layernorm as jax_ln
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    rng = np.random.default_rng(9)
    arrays = [_r(rng, 3, 7, 96), _r(rng, 96, s=0.1, mean=1.0),
              _r(rng, 96, s=0.1)]
    cots = [_r(rng, 3, 7, 96)]
    want = _jax_grads(lambda *a: jax_ln(*a, impl="xla"), arrays, cots)
    got = _port_grads(fused_layernorm, arrays, cots)
    for a, b in zip(got, want):
        _close(a, b)


def test_task_decode_grads_match_jax():
    """fused_task_decode's backward, the VJP of _decode_xla
    (task_decode.py:176-181), for every input."""
    from mtt_tpu.kernels.task_decode import fused_task_decode as jax_dec
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode
    rng = np.random.default_rng(10)
    B, S, C, T, G, tar, fin = 2, 12, 32, 3, 4, 10, 14
    arrays = [_r(rng, B, S, C), _r(rng, B, T, S, G), _r(rng, B, T, C),
              _r(rng, T, C, tar, s=0.2), _r(rng, T, tar, s=0.1),
              _r(rng, T, C, tar, s=0.2), _r(rng, T, tar, s=0.1),
              _r(rng, T, 2 * tar, fin, s=0.2), _r(rng, T, fin, s=0.1)]
    cots = [_r(rng, B, S, T * fin)]
    want = _jax_grads(lambda *a: jax_dec(*a, impl="xla"), arrays, cots)
    swap = (3, 5, 7)                 # (T, in, out) -> the port's (T, out, in)

    def port(*a):
        a = [t.transpose(1, 2).contiguous() if i in swap else t
             for i, t in enumerate(a)]
        return fused_task_decode(*a)

    got = _port_grads(port, arrays, cots)
    for a, b in zip(got, want):
        _close(a, b)
