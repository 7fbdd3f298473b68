"""The port's up4 head (kernels/head_up4.py, models/heads.py, the factored
conv3x3(upsample4) of models/layers.py) against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed. The JAX Pallas stencil kernel runs
in interpret mode as tests/test_kernels.py runs it; the port runs its plain
version, which rounds where the CUDA kernel rounds. Each test states its
tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model import random_variables


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _head_inputs(gh, gw, c, n, seed=0):
    """The inputs of tests/test_kernels.py:test_fused_up4_head_matches_xla."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, gh, gw, c)).astype(np.float32) * 0.3,
            rng.normal(size=(3, 3, c, c)).astype(np.float32) * 0.02,
            1.0 + 0.1 * rng.normal(size=(c,)).astype(np.float32),
            0.1 * rng.normal(size=(c,)).astype(np.float32),
            rng.normal(size=(c, n)).astype(np.float32) * 0.05)


@pytest.mark.parametrize("gh,gw", [(8, 8), (8, 12)])
def test_head_up4_plain_matches_pallas_interpret(gh, gw):
    """bf16, the main path's C = 350 and n = 21, square and non-square grids.
    Tolerance 4 bf16 ulps of the largest logit (4 * 2^-7 * max|logit|): the
    TPU kernel rounds its running logits to bf16 after each of its three
    128-channel chunks where the port sums in f32, and f32 sums taken in
    another order can flip a bf16 rounding of Gm, the width mix or the
    GELU output."""
    from mtt_tpu.kernels.head_up4 import fused_up4_head as jax_head
    from mtt_tpu_torch.kernels.head_up4 import head_up4_plain

    x, kc, inv, addv, kp = _head_inputs(gh, gw, 350, 21)
    want = np.asarray(jax_head(jnp.asarray(x, jnp.bfloat16), jnp.asarray(kc),
                               jnp.asarray(inv), jnp.asarray(addv),
                               jnp.asarray(kp), impl="interpret"))
    got = head_up4_plain(_t(x, torch.bfloat16), _t(kc), _t(inv), _t(addv),
                         _t(kp)).numpy()
    assert got.shape == want.shape == (2, 4 * gh, 4 * gw, 21)
    assert np.abs(got - want).max() <= 4 * 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("gh,gw", [(8, 8), (8, 12)])
def test_head_up4_plain_matches_head_xla(gh, gw):
    """f32 against JAX's XLA twin _head_xla, which uses the A&S erf GELU
    where the kernel and the plain version use the fast polynomial: the
    tolerance is 1e-5 of the logit scale plus 2.1e-4 (the fast GELU's error
    for |h| <= 9.2, checked on these inputs) times max_j sum_d |kp[d, j]|."""
    from mtt_tpu.kernels.head_up4 import _head_xla
    from mtt_tpu_torch.kernels.head_up4 import head_up4_plain
    from mtt_tpu_torch.models.layers import up4_conv3x3_factored

    x, kc, inv, addv, kp = _head_inputs(gh, gw, 96, 5, seed=1)
    want = np.asarray(_head_xla(*map(jnp.asarray, (x, kc, inv, addv, kp))))
    got = head_up4_plain(*map(_t, (x, kc, inv, addv, kp))).numpy()
    h = up4_conv3x3_factored(_t(x), _t(kc)) * _t(inv)[:, None, None] \
        + _t(addv)[:, None, None]
    assert h.abs().max() <= 9.2
    tol = 1e-5 * np.abs(want).max() + 2.1e-4 * np.abs(kp).sum(0).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


def test_gelu_fast_poly_matches_jax():
    """The same polynomial in f32 on both sides: to 1e-6."""
    from mtt_tpu.kernels.mlp import _gelu_erf_poly_fast
    from mtt_tpu_torch.kernels.mlp import gelu_erf_poly_fast

    h = np.linspace(-12, 12, 24001, dtype=np.float32)
    np.testing.assert_allclose(gelu_erf_poly_fast(_t(h)).numpy(),
                               np.asarray(_gelu_erf_poly_fast(jnp.asarray(h))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("gh,gw", [(4, 4), (8, 12)])
def test_up4_conv3x3_factored_matches_jax(gh, gw):
    """The factored composite of the training head, f32, channel-major
    output: rtol 1e-5 with a 1e-5 floor of the output scale."""
    from mtt_tpu.models.layers import up4_conv3x3_factored as jax_up4
    from mtt_tpu_torch.models.layers import up4_conv3x3_factored

    x, kc = _head_inputs(gh, gw, 24, 1, seed=2)[:2]
    want = np.asarray(jax_up4(jnp.asarray(x), jnp.asarray(kc)))
    got = up4_conv3x3_factored(_t(x), _t(kc)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _load(port, variables):
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return port


def test_factored_head_train_matches_jax():
    """ConvHead(up4='factored') in training, f32: logits, the updated
    running statistics (flax momentum 0.9, the biased batch variance) and
    the gradient of the input all within rtol 1e-5 and a 1e-5 floor of each
    tensor's scale."""
    from mtt_tpu.models.heads import ConvHead as JConvHead
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.models.heads import ConvHead

    x = np.random.default_rng(3).normal(size=(2, 4, 6, 24)).astype(np.float32)
    cot = np.random.default_rng(4).normal(size=(2, 16, 24, 5)).astype(
        np.float32)
    jm = JConvHead(5, up4="factored")
    v = random_variables(jm, jnp.asarray(x), seed=5)

    def f(xx):
        out, mut = jm.apply(v, xx, train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut)

    (_, (want, mut)), dx_want = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    port = _load(ConvHead(24, 5), v)
    xt = _t(x).requires_grad_()
    got = port(xt, train=True)
    (got * _t(cot)).sum().backward()

    def close(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())

    close(got.detach(), want)
    close(xt.grad, dx_want)
    stats = state_dict_from_flax({"params": {}, "batch_stats":
                                  mut["batch_stats"]})
    for k in ("mt_proj.bn.running_mean", "mt_proj.bn.running_var"):
        close(port.state_dict()[k], stats[k])


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("gh,gw", [(8, 8), (8, 12)])
def test_head_up4_stage_plains_compose_to_the_head(gh, gw, n):
    """The card runs the head as two launches, Gm on the shared GEMM and the
    mix kernel; their plain versions, composed, give head_up4_plain's bits
    in bf16 (C = 48), and Gm has the kernel's (B, gh, gw, 3, 3, D) layout."""
    from mtt_tpu_torch.kernels.head_up4 import (head_up4_gm_plain,
                                                head_up4_mix_plain,
                                                head_up4_plain)

    x, kc, inv, addv, kp = _head_inputs(gh, gw, 48, n, seed=6)
    args = (_t(x, torch.bfloat16), _t(kc), _t(inv), _t(addv), _t(kp))
    gm = head_up4_gm_plain(args[0], args[1])
    assert gm.shape == (2, gh, gw, 3, 3, 48) and gm.dtype == torch.bfloat16
    got = head_up4_mix_plain(gm, *args[2:])
    want = head_up4_plain(*args)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("g", [8, 12, 28, 32, 36])
def test_up4_bands_have_two_taps_per_output(g):
    """The mix kernel reads two of the three band entries of each output row
    or column per conv tap (csrc/head_up4.cu: tap_base): for output 4 s + p
    and tap k the upsampled position p + k - 1 lies between low-res s - 1
    and s when it is at most 1, else between s and s + 1. The third entry
    is exactly 0, at the map's borders too; away from them the two weights
    are the bilinear eighths."""
    from mtt_tpu_torch.kernels.head_up4 import _bands

    band = _bands(g)                                   # (4g, tap, 3)
    for W in range(4 * g):
        for k in range(3):
            base = 0 if (W % 4) + k - 1 <= 1 else 1
            assert band[W, k, 2 - 2 * base] == 0.0, (W, k, band[W, k])
            if 4 <= W < 4 * g - 4:
                # away from the borders, the bilinear eighths the kernel
                # uses as constants (csrc/head_up4.cu: tap_weight)
                pos8 = 2 * ((W % 4) + k - 1) - 3
                f8 = pos8 + 8 if pos8 < 0 else pos8
                assert band[W, k, base] == (8 - f8) / 8, (W, k)
                assert band[W, k, base + 1] == f8 / 8, (W, k)
