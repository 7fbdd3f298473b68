"""The port's kernel modules at the shapes JAX's models reach past the shipped
configs, against the JAX package, on the CPU: row 9 (InvPT attention) past
320 keys and at head dim 544, row 3 (LayerNorm) past 4096 columns and row 4's
plain stages at 4104, the attention core of rows 1-2 and 13 and row 7's
backward at head dims other than 64, and the InvPT decoder past 320 keys and
at a decoder width of 1088.

On the CPU every wrapper runs its plain version, the function its CUDA kernel
computes at the kernel's rounding points. The JAX side runs as its own tests
run it on the CPU: its Pallas kernels in interpret mode where their gates
admit the shape, else the XLA path JAX takes there. Inputs come from numpy
with a fixed seed, in f32 unless a test says otherwise. Tolerance, unless a
test says otherwise: max |port - jax| <= 1e-5 * max |jax| per output (the same
function in f32, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _n(rng, *shape, std=1.0):
    return (rng.normal(size=shape) * std).astype(np.float32)


def _close(got, want, rel=1e-5, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


# ---- row 9: the InvPT attention past 320 keys and past head dim 480 --------

def _invpt_inputs(Lq, Lk, D, with_msg, seed, B=1):
    rng = np.random.default_rng(seed)
    q, k, v = (_n(rng, B, 2, L, D) for L in (Lq, Lk, Lk))
    if not with_msg:
        return q, k, v, None, None, None
    return q, k, v, _n(rng, B, 2, Lq, Lk), _n(rng, 2, 4, std=0.5), \
        _n(rng, 2, std=0.1)


# Lk 338: the smallest square grid past 320 keys (2 tasks x 13 x 13); 1024:
# Cityscapes-3D's 2 tasks x 16 x 32; head dim 544: the stage-0 head dim at
# embed_dim 1024 ((1024 + 64) / 2); the streamed form takes all three
INVPT_SHAPES = [(338, 72), (1024, 72), (1024, 288), (40, 544)]


@pytest.mark.parametrize("with_msg", [False, True])
@pytest.mark.parametrize("Lk,D", INVPT_SHAPES)
def test_invpt_attention_plain_matches_xla_past_the_resident_reach(
        Lk, D, with_msg):
    """f32 against ``_forward_xla`` with a short Lq (24): out and fused to
    1e-5 of their scale."""
    from mtt_tpu.kernels.invpt_attention import _forward_xla
    from mtt_tpu_torch.kernels.invpt_attention import invpt_attention_plain

    a = _invpt_inputs(24, Lk, D, with_msg, seed=Lk + D)
    scale = (2 * D) ** -0.5
    want = _forward_xla(*map(_j, a), scale)
    got = invpt_attention_plain(*[None if x is None else _t(x) for x in a],
                                scale)
    _close(got[0], want[0], what="out")
    _close(got[1], want[1], what="fused")


@pytest.mark.parametrize("with_msg", [False, True])
@pytest.mark.parametrize("Lk,D", [(1024, 72), (40, 544)])
def test_invpt_attention_plain_matches_pallas_interpret_past_the_reach(
        Lk, D, with_msg):
    """bf16 q/k/v (f32 message) against the Pallas kernel in interpret mode
    (JAX's TPU kernel holds any key count in VMEM): fused to 1e-5 of its
    scale; out to 2 bf16 ulps of its largest value (p is rounded to bf16 at
    the same point, f32 sums in another order can flip that rounding)."""
    from mtt_tpu.kernels.invpt_attention import _forward_pallas
    from mtt_tpu_torch.kernels.invpt_attention import invpt_attention_plain

    q, k, v, msg, w, b = _invpt_inputs(16, Lk, D, with_msg, seed=7)
    scale = (2 * D) ** -0.5
    bf = jnp.bfloat16
    want = _forward_pallas(_j(q, bf), _j(k, bf), _j(v, bf), _j(msg), _j(w),
                           _j(b), scale, interpret=True)
    tb = torch.bfloat16
    got = invpt_attention_plain(
        _t(q, tb), _t(k, tb), _t(v, tb),
        *[None if x is None else _t(x) for x in (msg, w, b)], scale)
    _close(got[1], want[1], what="fused")
    _close(got[0], np.asarray(want[0].astype(jnp.float32)), 2 * 2.0 ** -7,
           "out")


@pytest.mark.parametrize("with_msg", [False, True])
@pytest.mark.parametrize("Lk,D", [(1024, 72), (40, 544)])
def test_invpt_attention_vjp_matches_jax_grad_past_the_reach(Lk, D,
                                                             with_msg):
    """The wrapper's backward (``invpt_attention_vjp``, the ported ``_bwd``)
    against ``jax.grad`` through both outputs, f32: every gradient (dq, dk,
    dv, dmsg, dw, db) to 1e-4 of its scale."""
    from mtt_tpu.kernels.invpt_attention import invpt_fused_attention as jfn
    from mtt_tpu_torch.kernels.invpt_attention import invpt_fused_attention

    Lq = 20
    a = _invpt_inputs(Lq, Lk, D, with_msg, seed=11)
    rng = np.random.default_rng(12)
    c_out = _n(rng, *a[0].shape)
    c_fused = _n(rng, 1, 2, Lq, Lk)
    scale = (2 * D) ** -0.5
    live = [i for i, x in enumerate(a) if x is not None]

    def loss(*args):
        full = [None] * 6
        for i, x in zip(live, args):
            full[i] = x
        out, fused = jfn(*full, scale, impl="xla")
        return (out * c_out).sum() + (fused * c_fused).sum()

    want = jax.grad(loss, argnums=tuple(range(len(live))))(
        *[_j(a[i]) for i in live])
    ts = [None if x is None else _t(x).requires_grad_() for x in a]
    out, fused = invpt_fused_attention(*ts, scale)
    ((out * _t(c_out)).sum() + (fused * _t(c_fused)).sum()).backward()
    for i, g in zip(live, want):
        _close(ts[i].grad, g, 1e-4, f"grad {i}")


# ---- rows 3 and 4 past 4096 columns -----------------------------------------

@pytest.mark.parametrize("C", [4104, 5440])
def test_layernorm_matches_pallas_past_4096(C):
    """The plain LayerNorm (``ln_f32``'s statistics) against JAX's Pallas
    LayerNorm in interpret mode at 5440 columns, InvPT's stage norm at
    embed_dim 1024 (5 tasks x 1088), and at 4104."""
    from mtt_tpu.kernels.layernorm import fused_layernorm as jax_ln
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm

    rng = np.random.default_rng(C)
    x = _n(rng, 2, 3, C)
    g, b = 1.0 + _n(rng, C, std=0.1), _n(rng, C, std=0.1)
    want = jax_ln(*map(jnp.asarray, (x, g, b)), impl="interpret")
    _close(fused_layernorm(_t(x), _t(g), _t(b)), want)


def test_mlp_ln_res_plain_stages_match_jax_past_4096():
    """Row 4's plain stages (LayerNorm, fc1 + b1 + GELU, fc2 + b2 + x) at C =
    4104 against JAX's half-block, which routes that width to XLA (its
    Pallas gate takes multiples of 128): the port's GELU is the kernel's
    A&S erf (|err| <= 1.5e-7), JAX's XLA path the exact erf."""
    from mtt_tpu.kernels.mlp import fused_mlp_ln_res as jax_mlp
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res

    rng = np.random.default_rng(3)
    C, Hd = 4104, 256
    x = _n(rng, 2, 5, C)
    g, b = 1.0 + _n(rng, C, std=0.1), _n(rng, C, std=0.1)
    w1, b1 = _n(rng, C, Hd, std=C ** -0.5), _n(rng, Hd, std=0.1)
    w2, b2 = _n(rng, Hd, C, std=Hd ** -0.5), _n(rng, C, std=0.1)
    want = jax_mlp(*map(jnp.asarray, (x, g, b, w1, b1, w2, b2)),
                   impl="interpret")
    got = fused_mlp_ln_res(_t(x), _t(g), _t(b), _t(w1.T), _t(b1), _t(w2.T),
                           _t(b2))
    _close(got, want)


# ---- rows 1-2, 13 and 7 at head dims other than 64 ---------------------------

HEAD_DIMS = [16, 32, 80, 128]


@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_attention_core_matches_jax_at_head_dim(D, safe, monkeypatch):
    """Row 13 (``fused_attention_qkv``) and the front half of rows 1-2
    (``fused_attention_ln_qkv``, the emit variant's three outputs) against
    JAX's, fast and safe softmax, 2 heads over 40 tokens: JAX's Pallas
    kernels in interpret mode where their gates admit the head dim (128),
    its XLA path elsewhere (16, 32, 80), which is the function JAX runs
    there. The fast softmax's exp2 and the XLA path's exp agree to f32
    rounding on these logits."""
    monkeypatch.delenv("MTT_ATTN_SAFE_SOFTMAX", raising=False)
    from mtt_tpu.kernels.attention import fused_attention_ln_qkv as jln
    from mtt_tpu.kernels.attention import fused_attention_qkv as jqkv
    from mtt_tpu_torch.kernels.attention import (fused_attention_ln_qkv,
                                                 fused_attention_qkv)

    rng = np.random.default_rng(D)
    B, N, H = 2, 40, 2
    C = H * D
    qkv = _n(rng, B, N, 3 * C, std=0.5)
    scale = D ** -0.5
    _close(fused_attention_qkv(_t(qkv), H, scale, safe=safe),
           jqkv(jnp.asarray(qkv), H, scale, impl="interpret", safe=safe),
           what="row 13")
    x = _n(rng, B, N, C)
    g, b = 1.0 + _n(rng, C, std=0.1), _n(rng, C, std=0.1)
    w, bq = _n(rng, C, 3 * C, std=0.05), _n(rng, 3 * C, std=0.05)
    want = jln(*map(jnp.asarray, (x, g, b, w, bq)), H, need_qkv=True,
               impl="interpret", safe=safe)
    got = fused_attention_ln_qkv(_t(x), _t(g), _t(b), _t(w.T), _t(bq), H,
                                 need_qkv=True, safe=safe)
    for name, gv, wv in zip(("out", "qkv", "xn"), got, want):
        _close(gv, wv, what=name)


@pytest.mark.parametrize("D", [16, 32])
def test_attn_core_bwd_plain_matches_jax_vjp_at_head_dim(D):
    """Row 7's plain version (``attn_core_bwd_plain``, the TPU backward
    kernel's function) against the VJP of JAX's attention core at ViT-T's
    head dim 16 and at 32 (f32: its bf16 roundings are exact); then the
    front half's whole backward (LN, projection and core) against
    ``jax.grad`` of JAX's ``fused_attention_ln_qkv``: dx, dgamma, dbeta,
    dw and db to 1e-4 of their scale."""
    from mtt_tpu.kernels.attention import fused_attention_ln_qkv as jln
    from mtt_tpu.kernels.attention import fused_attention_qkv as jqkv
    from mtt_tpu_torch.kernels.attention import (attn_core_bwd_plain,
                                                 fused_attention_ln_qkv)

    rng = np.random.default_rng(20 + D)
    B, N, H = 2, 33, 4
    C = H * D
    scale = D ** -0.5
    qkv, g = _n(rng, B, N, 3 * C, std=0.5), _n(rng, B, N, C)
    _, vjp = jax.vjp(lambda t: jqkv(t, H, scale, impl="interpret"),
                     jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    _close(attn_core_bwd_plain(_t(qkv), _t(g), H, scale), want, what="dqkv")

    x = _n(rng, B, N, C)
    gm, bt = 1.0 + _n(rng, C, std=0.1), _n(rng, C, std=0.1)
    w, bq = _n(rng, C, 3 * C, std=0.05), _n(rng, 3 * C, std=0.05)
    want = jax.grad(lambda *a: (jln(*a, H, impl="interpret") * g).sum(),
                    argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, gm, bt, w, bq)))
    ts = [_t(a).requires_grad_() for a in (x, gm, bt, w.T, bq)]
    (fused_attention_ln_qkv(*ts, H) * _t(g)).sum().backward()
    for name, t, wv in zip(("dx", "dgamma", "dbeta", "dw", "db"), ts, want):
        got = t.grad.t() if name == "dw" else t.grad
        _close(got, wv, 1e-4, what=name)


# ---- the InvPT decoder past 320 keys and at width 1088 ----------------------

NUM_OUT = {"semseg": 21, "human_parts": 7}


@pytest.mark.parametrize("grid,embed,pred", [
    ((52, 52), 16, 8), ((8, 8), 1024, 64)])
def test_invpt_decoder_matches_jax_past_the_reach(grid, embed, pred):
    """The port's ``InvPTDecoder`` against JAX's on random taps, 2 tasks,
    batch 1: on a 52x52 patch grid (h0 = 26) its kv length is 2 x 13 x 13 =
    338 at every stage, past the resident kernel's 320; at embed_dim 1024
    (decoder width 1088, stage head dims 544, 272 and 136, task-merged
    stage norms 2176, 1088 and 544 wide) on an 8x8 grid. Task features
    and intermediate predictions to 1e-5 of their scale."""
    from mtt_tpu.models.invpt import InvPTDecoder as JDec
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.models.invpt import InvPTDecoder

    tasks, Cb = tuple(NUM_OUT), 16
    taps = [np.random.default_rng(i).normal(
        size=(1, grid[0] * grid[1], Cb)).astype(np.float32)
        for i in range(4)]
    jm = JDec(tasks=tasks, num_outputs=NUM_OUT, embed_dim=embed,
              pred_out=pred, backbone_dim=Cb)
    holder = type("M", (), {"init": lambda s, k, a: jm.init(k, a, grid)})()
    v = random_variables(holder, [jnp.asarray(t) for t in taps], seed=5)
    want_f, want_ip = jax.jit(lambda v, taps: jm.apply(v, taps, grid))(
        v, [jnp.asarray(t) for t in taps])
    port = InvPTDecoder(tasks, NUM_OUT, embed_dim=embed, pred_out=pred,
                        backbone_dim=Cb, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    port.eval()
    with torch.no_grad():
        feats, ips = port([_t(t) for t in taps], grid)
    h0 = grid[0] // 2
    for t in tasks:
        assert feats[t].shape == (1, 8 * h0, 8 * h0, embed + pred)
        _close(feats[t], want_f[t], what=f"features {t}")
        _close(ips[t], want_ip[t], what=f"inter {t}")
