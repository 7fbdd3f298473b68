"""The PyTorch port's layers and blocks against the JAX package's, one module
at a time, in f32 on the CPU. Weights come from numpy with a seed over the
JAX module's variable shapes and reach the port through
``state_dict_from_flax``; inputs are numpy. Tolerance: rtol 1e-5 with an
absolute floor of 1e-5 times the output scale (same function, sums in
another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _load(port, variables):
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return port


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_patch_embed_matches_jax():
    from mtt_tpu.models.layers import PatchEmbed as JPatchEmbed
    from mtt_tpu_torch.models.layers import PatchEmbed

    x = _x(2, 64, 48, 3)
    jm = JPatchEmbed(16, 32)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    want, grid = jm.apply(v, jnp.asarray(x))
    got, got_grid = _load(PatchEmbed(16, 32), v)(torch.from_numpy(x))
    assert got_grid == grid == (4, 3)
    _close(got, want)


@pytest.mark.parametrize("size", [(32, 32), (13, 21), (5, 3)])
def test_interpolate_matches_jax(size):
    from mtt_tpu.models.layers import interpolate as jax_interp
    from mtt_tpu_torch.models.layers import interpolate

    x = _x(2, 8, 8, 5)
    _close(interpolate(torch.from_numpy(x), size),
           jax_interp(jnp.asarray(x), size))


def test_conv_head_dense_matches_jax():
    """ConvHead dense = ConvBNAct(3x3, bias, BN running stats, exact GELU)
    then the 1x1 logits."""
    from mtt_tpu.models.heads import ConvHead as JConvHead
    from mtt_tpu_torch.models.heads import ConvHead

    x = _x(2, 12, 10, 24)
    jm = JConvHead(5, up4=False)
    v = random_variables(jm, jnp.asarray(x), seed=2)
    want = jm.apply(v, jnp.asarray(x), train=False)
    _close(_load(ConvHead(24, 5, up4="dense"), v)(torch.from_numpy(x)), want)


@pytest.mark.parametrize("need_taps", [False, True])
def test_prompted_block_matches_jax(need_taps):
    """One block over the joint stream; tap blocks also return the raw
    spatial and channel prompt scores."""
    from mtt_tpu.models.taskprompter import PromptedBlock as JBlock
    from mtt_tpu_torch.models.taskprompter import PromptedBlock

    P, grid, C, H = 3, (4, 4), 64, 4
    x = _x(2, P + 16, C)
    jm = JBlock(H, P, (1, 1), grid)
    v = random_variables(jm, jnp.asarray(x), seed=3)
    want, wraw = jm.apply(v, jnp.asarray(x), need_taps=need_taps)
    port = _load(PromptedBlock(C, H, P, (1, 1), grid), v)
    with torch.no_grad():
        got, raw = port(torch.from_numpy(x), need_taps)
    _close(got, want)
    if need_taps:
        _close(raw.raw_spa, wraw.raw_spa)
        _close(raw.raw_chan, wraw.raw_chan)
    else:
        assert raw is None and wraw is None
