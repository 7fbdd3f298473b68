"""Every width a YAML gives JAX's models, on the CPU: the port's kernel
wrappers at widths and head dims that are not multiples of 8, row 3 on rows
that are not whole 16-byte chunks, row 5's split form past the one launch,
the MTT_DEBUG_TINY TaskPrompter-Swin built by ``build_model`` and InvPT's
factored eval tail.

On the CPU every wrapper runs its plain version. The card's kernels run
zero-padded to multiples of 8 where a width is not one (``_build.pad_to``);
the padded routes are checked here with the plain versions standing in for
the launches, against the plain versions at the true widths: a zero column
adds an exact 0 to every f32 sum, so the bits are equal. The JAX side runs
as its own tests run it on the CPU (Pallas kernels in interpret mode, or the
XLA path its gate takes). Inputs come from numpy with a fixed seed.
Tolerance, unless a test says otherwise: max |port - jax| <= 1e-5 * max |jax|
per output (the same function in f32, sums in another order).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_threads import torch_threads  # noqa: F401


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _n(rng, *shape, std=1.0):
    return (rng.normal(size=shape) * std).astype(np.float32)


def _close(got, want, rel=1e-5, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


# ---- the padded routes of rows 1-2, 4, 7, 8, 9 and 14 ------------------------

def _route(name, W, dt, rng):
    """(padded route with the plain versions at the padded widths, the
    plain version at the true widths) for wrapper ``name`` at width or head
    dim ``W``, activations in ``dt``."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels import attention as at
    from mtt_tpu_torch.kernels import invpt_attention as ia
    from mtt_tpu_torch.kernels import mlp
    from mtt_tpu_torch.kernels.layernorm import layernorm_plain

    def r(*shape, std=1.0, dtype=dt):
        return _t(_n(rng, *shape, std=std)).to(dtype)

    if name in ("mlp_fc", "mlp_ln_res"):
        C, Hd = W, 4 * W
        x = r(2, 9, C)
        w1, w2 = r(Hd, C, std=C ** -0.5), r(C, Hd, std=Hd ** -0.5)
        b1, b2 = r(Hd, std=0.1, dtype=torch.float32), \
            r(C, std=0.1, dtype=torch.float32)
        if name == "mlp_fc":
            return (mlp.mlp_fc_padded(x, w1, b1, w2, b2, mlp.mlp_fc_plain),
                    mlp.mlp_fc_plain(x, w1, b1, w2, b2))
        g = 1.0 + r(C, std=0.1, dtype=torch.float32)
        b = r(C, std=0.1, dtype=torch.float32)

        def pitched(xp, g, b, w1, b1, w2, b2, eps, C):
            # the LayerNorm launch at a padded pitch: statistics over the
            # first C columns, zeros past them
            xn = _build.pad_to(layernorm_plain(xp[..., :C], g, b, eps),
                               xp.shape[-1])
            return mlp.mlp_fc2_plain(mlp.mlp_fc1_gelu_plain(xn, w1, b1), w2,
                                     b2, res=xp)

        return (mlp.mlp_ln_res_padded(x, g, b, w1, b1, w2, b2, 1e-6,
                                      pitched),
                mlp.mlp_ln_res_plain(x, g, b, w1, b1, w2, b2))
    if name == "qkv_proj":
        xn, w = r(2, 9, W), r(3 * W, W, std=W ** -0.5)
        b = r(3 * W, std=0.1, dtype=torch.float32)
        return (at.qkv_proj_padded(xn, w, b, at.qkv_proj_plain),
                at.qkv_proj_plain(xn, w, b))
    H, scale = 2, W ** -0.5
    if name in ("core", "core_safe"):
        qkv, safe = r(2, 33, H * 3 * W, std=0.5), name == "core_safe"
        return (at.attn_core_padded(qkv, H, scale, safe,
                                    at.attention_qkv_plain),
                at.attention_qkv_plain(qkv, H, scale, safe))
    if name == "core_bwd":
        qkv, g = r(2, 33, H * 3 * W, std=0.5), r(2, 33, H * W)
        return (at.attn_core_bwd_padded(qkv, g, H, scale,
                                        at.attn_core_bwd_plain),
                at.attn_core_bwd_plain(qkv, g, H, scale))
    if name == "generic":
        q, k, v = r(2, 17, H, W), r(2, 11, H, W), r(2, 11, H, W)
        return (at.attention_generic_padded(q, k, v, scale,
                                            at.attention_generic_plain),
                at.attention_generic_plain(q, k, v, scale))
    if name == "invpt":
        q, k, v = r(2, H, 40, W), r(2, H, 12, W), r(2, H, 12, W)
        msg, w = r(2, H, 40, 12, dtype=torch.float32), \
            r(H, 2 * H, std=0.5, dtype=torch.float32)
        b = r(H, std=0.1, dtype=torch.float32)
        out, fused = ia.invpt_attention_padded(q, k, v, msg, w, b, scale,
                                               ia.invpt_attention_plain)
        return ((out.contiguous(), fused),
                ia.invpt_attention_plain(q, k, v, msg, w, b, scale))
    raise ValueError(name)


ROUTES = ([(n, w) for n in ("mlp_fc", "mlp_ln_res", "qkv_proj", "invpt")
           for w in (6, 83, 166)]
          + [(n, w) for n in ("core", "core_safe", "core_bwd", "generic")
             for w in (6, 83)])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,W", ROUTES)
def test_padded_route_keeps_the_bits(name, W, dt):
    """Each wrapper's route at widths (C, hidden, the qkv width) or head
    dims rounded up to multiples of 8, with the plain versions in place of
    the launches, equals the plain version at the true widths bit for bit:
    rows 8 and 4 (C = 6, 83, 166 and hidden 4 C; row 4's LayerNorm over the
    first C columns of its padded pitch), the qkv projection of rows 1-2,
    row 9 (head dims 6, 83, 166), the attention core of rows 1-2 and 13
    (fast and safe), row 7 and row 14."""
    rng = np.random.default_rng(W)
    got, want = _route(name, W, dt, rng)
    _equal(got, want)


# ---- row 3 on rows that are not whole 16-byte chunks -------------------------

@pytest.mark.parametrize("C", [830, 1660])
def test_layernorm_matches_pallas_at_ragged_widths(C):
    """The plain LayerNorm at InvPT's stage norms at embed_dim 600 (5 tasks
    x 166 and x 332) against JAX's Pallas LayerNorm in interpret mode."""
    from mtt_tpu.kernels.layernorm import fused_layernorm as jax_ln
    from mtt_tpu_torch.kernels.layernorm import (check_layernorm_width,
                                                 fused_layernorm)

    check_layernorm_width(C)
    rng = np.random.default_rng(C)
    x = _n(rng, 2, 3, C)
    g, b = 1.0 + _n(rng, C, std=0.1), _n(rng, C, std=0.1)
    want = jax_ln(*map(jnp.asarray, (x, g, b)), impl="interpret")
    _close(fused_layernorm(_t(x), _t(g), _t(b)), want)


# ---- row 5's split form -------------------------------------------------------

def _decode_args(rng, B, S, C, T, G, tar, fin, dt):
    x, a, cw = _n(rng, B, S, C), _n(rng, B, T, S, G), _n(rng, B, T, C)
    ws, wc = _n(rng, T, tar, C, std=0.2), _n(rng, T, tar, C, std=0.2)
    wf = _n(rng, T, fin, 2 * tar, std=0.1)
    bs, bc, bf = (_n(rng, T, n, std=0.1) for n in (tar, tar, fin))
    return [_t(x).to(dt), _t(a), _t(cw), _t(ws).to(dt), _t(bs),
            _t(wc).to(dt), _t(bc), _t(wf).to(dt), _t(bf)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_task_decode_split_stages_keep_the_one_piece_bits(dt):
    """The plain task decode as the split form's two stages ([f; fc] rounded
    to the dtype, then the fuse over the 2 tar columns) gives the bits of
    the one-piece formula written out here; so does the split form's
    zero-padded route at tar 13 (not a multiple of 4) and F 11 (odd), with
    the stages in place of the launches."""
    from mtt_tpu_torch.kernels.task_decode import (task_decode_plain,
                                                   task_decode_split_padded)

    rng = np.random.default_rng(5)
    B, S, C, T, G, tar, fin = 2, 7, 16, 3, 2, 13, 11
    x, a, cw, ws, bs, wc, bc, wf, bf = _decode_args(rng, B, S, C, T, G, tar,
                                                    fin, dt)
    xt = x[:, None]
    f_in = xt * a.to(dt).repeat_interleave(C // G, -1) + xt
    fc_in = xt * cw.to(dt)[:, :, None] + xt
    f = (torch.einsum("btsc,trc->bstr", f_in.float(), ws.float())
         + bs).to(dt)
    fc = (torch.einsum("btsc,trc->bstr", fc_in.float(), wc.float())
          + bc).to(dt)
    y = torch.einsum("bstr,tfr->bstf", torch.cat([f, fc], -1).float(),
                     wf.float()) + bf
    want = y.to(dt).reshape(B, S, T * fin)
    args = (x, a, cw, ws, bs, wc, bc, wf, bf)
    _equal(task_decode_plain(*args), want)
    _equal(task_decode_split_padded(*args, task_decode_plain), want)


def test_task_decode_matches_jax_past_the_one_launch():
    """The port's task decode at tar 320 and F 360 (past the one launch's
    304 and 352, where the card runs the split form) against JAX's, f32."""
    from mtt_tpu.kernels.task_decode import fused_task_decode as jax_dec
    from mtt_tpu_torch.kernels.task_decode import (fused_task_decode,
                                                   task_decode_one_launch)

    assert not task_decode_one_launch(320, 360)
    assert task_decode_one_launch(300, 350)
    rng = np.random.default_rng(6)
    args = _decode_args(rng, 1, 8, 32, 2, 2, 320, 360, torch.float32)
    x, a, cw, ws, bs, wc, bc, wf, bf = (t.numpy() for t in args)
    want = jax_dec(*map(jnp.asarray, (
        x, a, cw, ws.transpose(0, 2, 1), bs, wc.transpose(0, 2, 1), bc,
        wf.transpose(0, 2, 1), bf)), impl="xla")
    _close(fused_task_decode(*args), want)


# ---- the MTT_DEBUG_TINY TaskPrompter-Swin -------------------------------------

CS3D_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "cityscapes3d",
    "taskprompter_swinB.yml")


def test_debug_tiny_swin_loads_jax_tree_strictly(monkeypatch):
    """JAX's ``build_model`` under MTT_DEBUG_TINY=1 on the Cityscapes-3D
    YAML (the tiny backbone and detection head), its variable tree through
    ``jax.eval_shape`` at 128x256, loads strictly into the port's
    ``build_model(p, debug_tiny=True)`` by ``state_dict_from_flax``; the
    port's default reads the same variable, and the caller's ``det_cfg`` is
    left as it was."""
    from mtt_tpu.config.config import create_config as jax_config
    from mtt_tpu.models.wrappers import build_model as jax_build
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.models.wrappers import TINY_SWIN_SPEC, build_model

    monkeypatch.setenv("MTT_DEBUG_TINY", "1")
    size = (128, 256)
    jm = jax_build(jax_config(CS3D_YAML, {"run_mode": "infer"}))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *size, 3), jnp.float32)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    p = create_config(CS3D_YAML, {"run_mode": "infer"})
    for tiny in (True, None):
        port = build_model(p, size, debug_tiny=tiny, device="cpu")
        port.load_state_dict(state_dict_from_flax(tree), strict=True)
    assert port.backbone.patch_embed.out_channels == \
        TINY_SWIN_SPEC["embed_dim"]
    assert port.det_cfg["feat_channels"] == 16
    assert port.det_cfg["neck"]["out_channels"] == 16
    assert p.det_cfg["feat_channels"] == 256
    assert p.det_cfg["neck"]["out_channels"] == 256
    monkeypatch.delenv("MTT_DEBUG_TINY")
    full = build_model(p, size, device="cpu")
    assert full.det_cfg["feat_channels"] == 256


# ---- InvPT's factored eval tail ------------------------------------------------

NUM_OUT = {"semseg": 21, "human_parts": 7}


def _decoders(grid, embed, pred, seed):
    from mtt_tpu.models.invpt import InvPTDecoder as JDec
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.models.invpt import InvPTDecoder
    from test_torch_model import random_variables

    tasks, Cb = tuple(NUM_OUT), 16
    taps = [np.random.default_rng(i).normal(
        size=(1, grid[0] * grid[1], Cb)).astype(np.float32)
        for i in range(4)]
    jm = JDec(tasks=tasks, num_outputs=NUM_OUT, embed_dim=embed,
              pred_out=pred, backbone_dim=Cb)
    holder = type("M", (), {"init": lambda s, k, a: jm.init(k, a, grid)})()
    v = random_variables(holder, [jnp.asarray(t) for t in taps], seed=seed)
    port = InvPTDecoder(tasks, NUM_OUT, embed_dim=embed, pred_out=pred,
                        backbone_dim=Cb, factored_tail=True, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, taps, port.eval()


def test_factored_tail_matches_jax(monkeypatch):
    """The port's ``InvPTDecoder(factored_tail=True)`` eval forward against
    JAX's under MTT_INVPT_FACTORED=1 (its ``upf_conv3x3_factored`` tail) on
    an 8x8 patch grid, 2 tasks, decoder width 24: task features to 1e-5 of
    their scale. The same weights through the tail kernel's plain version
    agree to 1e-5 too (the conv distributes over the multi-scale sum)."""
    monkeypatch.setenv("MTT_INVPT_FACTORED", "1")
    grid = (8, 8)
    jm, v, taps, port = _decoders(grid, 16, 8, seed=9)
    want, _ = jax.jit(lambda v, taps: jm.apply(v, taps, grid))(
        v, [jnp.asarray(t) for t in taps])
    with torch.no_grad():
        feats, _ = port([_t(t) for t in taps], grid)
        port.factored_tail = False
        kern, _ = port([_t(t) for t in taps], grid)
    for t in NUM_OUT:
        assert feats[t].shape == (1, 32, 32, 24)
        _close(feats[t], want[t], what=f"factored {t}")
        _close(kern[t], want[t], what=f"kernel tail {t}")


def test_factored_tail_yields_to_the_head_and_to_training():
    """JAX's precedence: the head-fused tail wins over the factored one,
    and a training forward takes the dense tail: with ``factored_tail`` on
    and off the decoder gives the same bits there."""
    grid = (8, 8)
    _, _, taps, port = _decoders(grid, 16, 8, seed=10)
    heads = {t: (_t(_n(np.random.default_rng(1), 24, n, std=0.2)),
                 _t(_n(np.random.default_rng(2), n, std=0.1)))
             for t, n in NUM_OUT.items()}
    x = [_t(t) for t in taps]
    state = {k: v.clone() for k, v in port.state_dict().items()}
    outs = []
    for factored in (True, False):
        port.load_state_dict(state)
        port.factored_tail = factored
        with torch.no_grad():
            head, _ = port(x, grid, head_params=heads)
            train, _ = port(x, grid, train=True,
                            generator=torch.Generator().manual_seed(3))
        outs.append((head, train))
    for t in NUM_OUT:
        assert torch.equal(outs[0][0][t], outs[1][0][t])
        assert torch.equal(outs[0][1][t], outs[1][1][t])
