"""The port's InvPT modules and its whole ``TransformerNet`` eval forward
against the JAX package, on the CPU.

Small sizes: ViT-T (``vitT``), embed_dim 32, PRED_OUT 8 (decoder width 40, 20,
10), 5 PASCAL tasks, 64x64 and the non-square 64x128. The JAX weights are
made with numpy from a seed over the shapes of the JAX module's tree, carried
into the port by ``state_dict_from_flax`` (strict load), and both sides run
the same numpy inputs in f32.

Tolerance, unless a test says otherwise: max |port - jax| <= 1e-5 * max |jax|
per output: the same function in f32 with sums in another order (the port's
MLP GELU on the A&S erf, |err| <= 1.5e-7; the factored tail against JAX's
dense composition on the CPU).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401

TASKS = ("semseg", "human_parts", "sal", "normals", "edge")
NUM_OUT = {"semseg": 21, "human_parts": 7, "sal": 2, "normals": 3, "edge": 1}
EMBED, PRED = 32, 8
SIZES = [(64, 64), (64, 128)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _load(port, variables, **kw):
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    port.load_state_dict(state_dict_from_flax(variables, **kw), strict=True)
    return port.eval()


def _close(got, want, rel=1e-5, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("size", SIZES)
def test_vision_transformer_matches_jax(size):
    """Every tap (after blocks 1, 2, 3 and the final norm, cls row stripped)
    and the final tokens."""
    from mtt_tpu.models.vit import build_vit as jbuild
    from mtt_tpu_torch.models.vit import build_vit

    x = _rand(0, 2, *size, 3)
    jm = jbuild("vitT", size, drop_path_rate=0.0)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    want_final, want_taps = jm.apply(v, jnp.asarray(x))
    port = _load(build_vit("vitT", size, device="cpu"), v)
    with torch.no_grad():
        final, taps = port(_t(x))
    assert len(taps) == len(want_taps) == 4
    _close(final, want_final, what="final")
    for i, (g, w) in enumerate(zip(taps, want_taps)):
        _close(g, w, what=f"tap {i}")


def test_vit_block_train_branch_matches_jax():
    """The training branch of ``ViTBlock`` (safe softmax, LayerNorm + the
    plain MLP) with the drop-path rate at 0, where it must equal the fused
    half-block: the port's two branches agree with each other and with JAX."""
    from mtt_tpu.models.layers import ViTBlock as JBlock
    from mtt_tpu_torch.models.layers import ViTBlock, drop_path

    x = _rand(0, 2, 9, 64)
    jm = JBlock(4)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    want = jm.apply(v, jnp.asarray(x), True)
    port = _load(ViTBlock(64, 4), v)
    _close(port(_t(x)), want)
    _close(port(_t(x), train=True), want)
    port.drop_path = 0.5       # the unfused branch; masks from a generator
    gen = torch.Generator().manual_seed(0)
    out = port(_t(x), train=True, generator=gen)
    assert out.shape == x.shape and torch.isfinite(out).all()
    # a dropped sample is zero, a kept one is scaled by 1 / keep
    m = drop_path(torch.ones(64, 3), 0.5, torch.Generator().manual_seed(1))
    assert set(m.unique().tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError, match="torch.Generator"):
        port(_t(x), train=True)


def test_resize_pos_embed_matches_jax():
    """JAX's cubic (Keys a = -0.5), up and down and non-square: 1e-5."""
    from mtt_tpu.models.vit import resize_pos_embed as jresize
    from mtt_tpu_torch.models.vit import resize_pos_embed

    pe = _rand(0, 1, 1 + 36, 16)
    for grid in [(8, 8), (4, 10), (6, 6)]:
        want = jresize(jnp.asarray(pe), grid)
        _close(resize_pos_embed(_t(pe), grid), want, what=str(grid))


@pytest.mark.parametrize("kw,shape", [
    (dict(), (2, 3, 6, 8, 10)),                                 # plain 3x3
    (dict(strides=(2, 2), depthwise=True), (2, 3, 6, 8, 10)),   # the q conv
    (dict(dilation=(2, 2)), (2, 3, 6, 8, 10)),                  # UpEmbed's
])
def test_task_stack_conv_bn_matches_jax(kw, shape):
    """One grouped conv over the merged T*C axis: group layout (HWIO ->
    OIHW with groups), symmetric padding under stride 2 (XLA SAME would shift
    every window), dilation, and BN over the merged axis."""
    from mtt_tpu.models.invpt import TaskStackConvBN as JConv
    from mtt_tpu_torch.models.invpt import TaskStackConvBN

    x = _rand(0, *shape)
    T, C = shape[1], shape[-1]
    features = C if kw.get("depthwise") else 12
    jm = JConv(features, **kw)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    want = jm.apply(v, jnp.asarray(x))
    port = _load(TaskStackConvBN(
        T, C, features, 3, dilation=kw.get("dilation", (1, 1))[0],
        stride=kw.get("strides", (1, 1))[0],
        depthwise=kw.get("depthwise", False)), v)
    _close(port(_t(x)), want)


def test_up_embed_matches_jax():
    from mtt_tpu.models.invpt import UpEmbed as JUp
    from mtt_tpu_torch.models.invpt import UpEmbed

    x = _rand(0, 2, 3, 4, 6, 16)
    jm = JUp(8)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    _close(_load(UpEmbed(3, 16, 8), v)(_t(x)), jm.apply(v, jnp.asarray(x)))


def test_cross_task_attention_with_message_matches_jax():
    """Stage-1 geometry: kv stride 4, the previous stage's f32 message on the
    half-size query grid, upsampled and mixed in; both outputs (the attention
    output at block resolution and the new message)."""
    from mtt_tpu.models.invpt import CrossTaskAttention as JAttn
    from mtt_tpu_torch.models.invpt import CrossTaskAttention

    B, T, H, W, C = 2, 3, 8, 16, 20
    x = _rand(0, B, T, H, W, C)
    Lk = T * (H // 4) * (W // 4)
    msg = _rand(1, B, 2, T * (H // 4) * (W // 4), Lk)
    jm = JAttn(C, kv_stride=4)
    shapes_v = random_variables(
        type("M", (), {"init": lambda s, k, a: jm.init(k, a, jnp.asarray(msg))
                       })(), jnp.asarray(x), seed=2)
    want_out, want_msg = jm.apply(shapes_v, jnp.asarray(x), jnp.asarray(msg))
    port = _load(CrossTaskAttention(T, C, kv_stride=4, with_message=True),
                 shapes_v)
    with torch.no_grad():
        out, new_msg = port(_t(x), _t(msg))
    assert new_msg.dtype == torch.float32
    _close(out, want_out, what="out")
    _close(new_msg, want_msg, what="message")


def _jax_net():
    from mtt_tpu.models.wrappers import TransformerNet
    return TransformerNet(tasks=TASKS, num_outputs=NUM_OUT,
                          backbone_name="vitT", embed_dim=EMBED,
                          pred_out=PRED)


def _port_net(size, tail_head=False):
    from mtt_tpu_torch.models.wrappers import TransformerNet
    return TransformerNet(TASKS, NUM_OUT, size, "vitT", embed_dim=EMBED,
                          pred_out=PRED, tail_head=tail_head, device="cpu")


_CACHE = {}


def _net_case(size):
    """One JAX init and forward per input size, shared by the tests below.
    At the square size the JAX forward also runs with the head fused into the
    tail (MTT_TAIL_HEAD=1), as its wrapper selects it; at the other size both
    of the port's settings are held to JAX's default forward, which computes
    the same function."""
    if size not in _CACHE:
        x = _rand(0, 2, *size, 3)
        jm = _jax_net()
        v = random_variables(jm, jnp.asarray(x), seed=1)
        # jitted, one trace each (the wrapper reads MTT_TAIL_HEAD while it
        # traces): the eager forward compiles op by op, 3-4x slower
        want = {False: jax.jit(lambda v, x: jm.apply(v, x))(
            v, jnp.asarray(x))}
        want[True] = want[False]
        if size[0] == size[1]:
            old = os.environ.get("MTT_TAIL_HEAD")
            os.environ["MTT_TAIL_HEAD"] = "1"
            try:
                want[True] = jax.jit(lambda v, x: jm.apply(v, x))(
                    v, jnp.asarray(x))
            finally:
                if old is None:
                    del os.environ["MTT_TAIL_HEAD"]
                else:
                    os.environ["MTT_TAIL_HEAD"] = old
        _CACHE[size] = (x, v, want)
    return _CACHE[size]


@pytest.mark.parametrize("tail_head", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_transformer_net_matches_jax(size, tail_head):
    """The whole InvPT eval forward: every task map and every ``inter_preds``
    map, with the fused tail and with the head-fused tail, square and
    non-square input."""
    x, v, want = _net_case(size)
    port = _load(_port_net(size, tail_head), v)
    with torch.no_grad():
        got = port(_t(x))
    assert set(got) == set(TASKS) | {"inter_preds"}
    for t, n in NUM_OUT.items():
        assert got[t].shape == (2, *size, n)
        _close(got[t], want[tail_head][t], what=t)
        _close(got["inter_preds"][t], want[tail_head]["inter_preds"][t],
               what=f"inter_preds.{t}")


def test_invpt_decoder_matches_jax():
    """The decoder alone on random taps: task features at 8x the preamble
    grid and the intermediate predictions. The transposed conv
    ``scale_embed_0`` (kernel flipped, flax padding ((1, 2), (1, 2)) = torch
    padding 1 + output_padding 1) feeds stage 2's skip."""
    from mtt_tpu.models.invpt import InvPTDecoder as JDec
    from mtt_tpu_torch.models.invpt import InvPTDecoder

    grid, Cb = (4, 8), 24
    taps = [_rand(i, 2, grid[0] * grid[1], Cb) for i in range(4)]
    jm = JDec(tasks=TASKS, num_outputs=NUM_OUT, embed_dim=EMBED,
              pred_out=PRED, backbone_dim=Cb)
    holder = type("M", (), {"init": lambda s, k, a: jm.init(k, a, grid)})()
    v = random_variables(holder, [jnp.asarray(t) for t in taps], seed=5)
    want_f, want_ip = jm.apply(v, [jnp.asarray(t) for t in taps], grid)
    port = _load(InvPTDecoder(TASKS, NUM_OUT, embed_dim=EMBED, pred_out=PRED,
                              backbone_dim=Cb), v)
    with torch.no_grad():
        feats, ips = port([_t(t) for t in taps], grid)
    for t in TASKS:
        assert feats[t].shape == (2, 16, 32, EMBED + PRED)
        _close(feats[t], want_f[t], what=f"features {t}")
        _close(ips[t], want_ip[t], what=f"inter {t}")


def test_invpt_decoder_train_branch_runs_and_updates_bn():
    """The dense training tail (batch statistics, running averages) and the
    per-sample drop-path: finite outputs of the eval shapes, and the tail's
    running statistics move. Then the train branch against the JAX decoder
    in train mode on the same weights and taps, drop-path off on both sides
    (the JAX ``DropPath`` patched to a pass-through, the port's blocks at
    rate 0): the task features, the intermediate predictions and every
    running statistic after the forward (flax's fast variance in the
    grouped and depthwise conv BNs and the preamble, the tail's centred
    variance, momentum 0.9), to 1e-5 of each output's largest value."""
    from flax import linen as fnn

    import mtt_tpu.models.invpt as jinvpt
    from mtt_tpu.models.invpt import InvPTDecoder as JDec
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.models.invpt import InvPTDecoder
    from mtt_tpu_torch.models.layers import init_weights

    grid, Cb = (4, 4), 16
    gen = torch.Generator().manual_seed(0)
    port = InvPTDecoder(TASKS[:2], NUM_OUT, embed_dim=16, pred_out=8,
                        backbone_dim=Cb, device="cpu")
    init_weights(port, gen)
    taps = [_t(_rand(i, 2, 16, Cb)) for i in range(4)]
    before = port.mt_proj_semseg.bn.running_mean.clone()
    feats, _ = port(taps, grid, train=True, generator=gen)
    assert feats["semseg"].shape == (2, 16, 16, 24)
    assert all(torch.isfinite(f).all() for f in feats.values())
    assert not torch.equal(before, port.mt_proj_semseg.bn.running_mean)

    class NoDropPath(fnn.Module):
        rate: float = 0.0

        @fnn.compact
        def __call__(self, x, *, deterministic: bool = True):
            return x

    # an 8x8 grid: at 4x4 the first stage's query grid is 1x1 and its BN
    # normalises 2 values a channel
    grid = (8, 8)
    taps = [_rand(10 + i, 2, 64, Cb) for i in range(4)]
    jm = JDec(tasks=TASKS[:2], num_outputs=NUM_OUT, embed_dim=16, pred_out=8,
              backbone_dim=Cb)
    holder = type("M", (), {"init": lambda s, k, a: jm.init(k, a, grid)})()
    v = random_variables(holder, [jnp.asarray(t) for t in taps], seed=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinvpt, "DropPath", NoDropPath)
        (want_f, want_ip), new = jax.jit(lambda v, taps: jm.apply(
            v, taps, grid, train=True, mutable=["batch_stats"]))(
                v, [jnp.asarray(t) for t in taps])
    port = InvPTDecoder(TASKS[:2], NUM_OUT, embed_dim=16, pred_out=8,
                        backbone_dim=Cb, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    for i in range(3):
        getattr(port, f"stage_{i}").drop_path = 0.0
    with torch.no_grad():
        feats, ips = port([_t(t) for t in taps], grid, train=True)
    for t in TASKS[:2]:
        _close(feats[t], want_f[t], what=f"features {t}")
        _close(ips[t], want_ip[t], what=f"inter {t}")
    want_bs = state_dict_from_flax({"params": {},
                                    "batch_stats": new["batch_stats"]})
    got_bs = {k: b for k, b in port.state_dict().items() if "running" in k}
    assert got_bs.keys() == {k for k in want_bs if "running" in k}
    for k, b in got_bs.items():
        _close(b, want_bs[k], what=k)


def test_convert_jax_flips_transposed_conv_and_keeps_groups():
    """The two layout changes this slice adds to ``state_dict_from_flax``."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax

    k = _rand(0, 3, 3, 4, 6)
    sd = state_dict_from_flax({"params": {
        "scale_embed_0": {"kernel": k}, "conv": {"kernel": k},
        "attn": {"fuse_attn_kernel": _rand(1, 2, 4),
                 "fuse_attn_bias": _rand(2, 2)},
        "cls_token": _rand(3, 1, 1, 8)}})
    np.testing.assert_array_equal(
        sd["scale_embed_0.weight"].numpy(),
        k[::-1, ::-1].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(sd["conv.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    assert sd["attn.fuse_attn_kernel"].shape == (2, 4)
    assert sd["attn.fuse_attn_bias"].shape == (2,)
    assert sd["cls_token"].shape == (1, 1, 8)


def test_build_model_invpt_defaults_to_the_card(monkeypatch):
    """``build_model`` on the InvPT settings returns a ``TransformerNet``; it
    builds on the card by default and raises without one."""
    from mtt_tpu_torch.models.wrappers import (INVPT_PASCAL_VITL,
                                               TransformerNet, build_model)
    p = dict(INVPT_PASCAL_VITL, backbone="vitT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(p)
    model = build_model(p, img_size=(64, 64), tail_head=True, device="meta")
    assert isinstance(model, TransformerNet) and model.tail_head
    assert model.tasks == ("semseg", "human_parts", "sal", "normals", "edge")
    assert model.decoder.dims == (576, 288, 144)
    with pytest.raises(NotImplementedError, match="mlp"):
        build_model(dict(p, head="conv"), device="meta")


def test_predict_accepts_transformer_net_output():
    """``predict`` post-processes the task maps and leaves ``inter_preds``
    (not a task map) in the logits only; a wrong input size raises."""
    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.models.layers import init_weights

    model = _port_net((64, 64)).eval()
    init_weights(model, torch.Generator().manual_seed(0))
    logits, preds = predict(model, _t(_rand(0, 1, 64, 64, 3)))
    assert set(preds) == set(TASKS)
    assert set(logits["inter_preds"]) == set(TASKS)
    assert preds["semseg"].shape == (1, 64, 64)
    with pytest.raises(ValueError, match="position embedding"):
        model(_t(_rand(0, 1, 64, 128, 3)))
