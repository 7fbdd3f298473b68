"""The port's InvPT kernels' plain versions (kernels/invpt_attention.py,
kernels/invpt_tail.py) against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed. The JAX Pallas kernels run in
interpret mode, as tests/test_kernels.py runs them, and through their XLA
twins; the port runs its plain versions, which round where the CUDA kernels
round. Each test states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _close(got, want, rel, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


# ---------------------------------------------------------------- attention

def _attn_inputs(Lq, D, with_msg, seed=0, B=2, H=2, Lk=40):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    q, k, v = n(B, H, Lq, D), n(B, H, Lk, D), n(B, H, Lk, D)
    if not with_msg:
        return q, k, v, None, None, None
    return q, k, v, n(B, H, Lq, Lk), 0.5 * n(H, 2 * H), 0.1 * n(H)


@pytest.mark.parametrize("with_msg", [False, True])
@pytest.mark.parametrize("D", [72, 144])
def test_invpt_attention_plain_matches_xla(D, with_msg):
    """f32 against ``_forward_xla`` at head dims 72 and 144 and an Lq (150)
    that is not a multiple of 128: out and fused to 1e-5 of their scale (the
    same function, sums in another order)."""
    from mtt_tpu.kernels.invpt_attention import _forward_xla
    from mtt_tpu_torch.kernels.invpt_attention import invpt_attention_plain

    a = _attn_inputs(150, D, with_msg)
    scale = (2 * D) ** -0.5
    want = _forward_xla(*map(_j, a), scale)
    got = invpt_attention_plain(*[None if x is None else _t(x) for x in a],
                                scale)
    assert got[1].dtype == torch.float32
    _close(got[0], want[0], 1e-5, "out")
    _close(got[1], want[1], 1e-5, "fused")


@pytest.mark.parametrize("with_msg", [False, True])
@pytest.mark.parametrize("D", [72, 144])
def test_invpt_attention_plain_matches_pallas_interpret(D, with_msg):
    """bf16 q/k/v (f32 message) against the Pallas kernel in interpret mode.
    fused is f32 on both sides, from exact bf16 products: 1e-5 of its scale.
    out: 2 bf16 ulps of its largest value (2 * 2^-7 * max|out|), because p is
    rounded to bf16 at the same point but f32 sums in another order can flip
    that rounding or the output's."""
    from mtt_tpu.kernels.invpt_attention import _forward_pallas
    from mtt_tpu_torch.kernels.invpt_attention import invpt_attention_plain

    q, k, v, msg, w, b = _attn_inputs(150, D, with_msg, seed=1)
    scale = (2 * D) ** -0.5
    bf = jnp.bfloat16
    want = _forward_pallas(_j(q, bf), _j(k, bf), _j(v, bf), _j(msg), _j(w),
                           _j(b), scale, interpret=True)
    tb = torch.bfloat16
    got = invpt_attention_plain(
        _t(q, tb), _t(k, tb), _t(v, tb),
        *[None if x is None else _t(x) for x in (msg, w, b)], scale)
    assert got[0].dtype == tb and got[1].dtype == torch.float32
    _close(got[1], want[1], 1e-5, "fused")
    _close(got[0], np.asarray(want[0].astype(jnp.float32)), 2 * 2.0 ** -7,
           "out")


@pytest.mark.parametrize("with_msg", [False, True])
def test_invpt_attention_backward_matches_jax_grad(with_msg):
    """The wrapper's backward (the ported ``_bwd``) against ``jax.grad``
    through BOTH outputs, f32: every gradient (dq, dk, dv, dmsg, dw, db) to
    1e-4 of its scale."""
    from mtt_tpu.kernels.invpt_attention import invpt_fused_attention as jfn
    from mtt_tpu_torch.kernels.invpt_attention import invpt_fused_attention

    a = _attn_inputs(70, 72, with_msg, seed=2)
    rng = np.random.default_rng(3)
    c_out = rng.normal(size=a[0].shape).astype(np.float32)
    c_fused = rng.normal(size=(2, 2, 70, 40)).astype(np.float32)
    scale = 144 ** -0.5
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


def test_invpt_attention_wrapper_refuses():
    from mtt_tpu_torch.kernels.invpt_attention import (invpt_attention_cuda,
                                                       invpt_fused_attention)
    q, k, v, msg, w, b = [None if x is None else _t(x)
                          for x in _attn_inputs(8, 16, True)]
    with pytest.raises(ValueError, match="come together"):
        invpt_fused_attention(q, k, v, msg, None, None, 1.0)
    with pytest.raises(ValueError, match="msg must be"):
        invpt_fused_attention(q, k, v, msg[:, :, :4], w, b, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        invpt_fused_attention(q, k, v, msg, w, b, 1.0, impl="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        invpt_attention_cuda(q, k, v, msg, w, b, 1.0)
    q4 = torch.zeros(1, 4, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="2 heads"):
        invpt_attention_cuda(q4, q4, q4, None, None, None, 1.0)


# --------------------------------------------------------------------- tail

def _tail_inputs(h0, w0, C, D, n, seed=0, B=2):
    rng = np.random.default_rng(seed)
    n_ = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    xs = tuple(0.5 * n_(B, h0 * m, w0 * m, C) for m in (1, 2, 4))
    return (xs, n_(3, 3, C, D) * (9 * C) ** -0.5, 1.0 + 0.1 * n_(D),
            0.1 * n_(D), n_(D, n) * D ** -0.5, 0.1 * n_(n))


GRIDS = [(6, 6), (6, 8)]       # x0's grid; the output is 8x that


@pytest.mark.parametrize("h0,w0", GRIDS)
def test_ms_tail_plain_matches_tail_xla(h0, w0):
    """f32, both forms against the dense composition ``_tail_xla`` (+ the
    1x1 for the head): 1e-5 of the output scale. The factored algebra is
    exact; only the order of the f32 sums differs."""
    from mtt_tpu.kernels.invpt_tail import _tail_xla
    from mtt_tpu_torch.kernels.invpt_tail import (ms_tail_head_plain,
                                                  ms_tail_plain)

    xs, kc, inv, addv, wh, bh = _tail_inputs(h0, w0, 24, 40, 5)
    th, tw = 8 * h0, 8 * w0
    want = np.asarray(_tail_xla(tuple(map(_j, xs)), _j(kc), _j(inv),
                                _j(addv), th, tw))
    txs = tuple(map(_t, xs))
    _close(ms_tail_plain(txs, _t(kc), _t(inv), _t(addv), th, tw), want, 1e-5)
    _close(ms_tail_head_plain(txs, _t(kc), _t(inv), _t(addv), _t(wh), _t(bh),
                              th, tw), want @ wh + bh, 1e-5)


@pytest.mark.parametrize("h0,w0", GRIDS)
def test_ms_tail_plain_matches_pallas_interpret(h0, w0):
    """bf16 against the Pallas stencil kernel in interpret mode, factors 8, 4
    and 2, square and non-square: 4 bf16 ulps of the largest output value
    (4 * 2^-7 * max): Gm and the width mix are rounded to bf16 at the same
    points on both sides, and f32 sums taken in another order can flip one of
    those roundings or the output's."""
    from mtt_tpu.kernels.invpt_tail import fused_ms_tail as jtail
    from mtt_tpu_torch.kernels.invpt_tail import fused_ms_tail

    xs, kc, inv, addv, _, _ = _tail_inputs(h0, w0, 16, 136, 5, seed=1, B=1)
    th, tw = 8 * h0, 8 * w0
    bf = jnp.bfloat16
    want = jtail(tuple(_j(x, bf) for x in xs), _j(kc), _j(inv), _j(addv), th,
                 tw, impl="interpret")
    got = fused_ms_tail(tuple(_t(x, torch.bfloat16) for x in xs), _t(kc),
                        _t(inv), _t(addv), th, tw)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), 4 * 2.0 ** -7)


@pytest.mark.parametrize("h0,w0", GRIDS)
def test_ms_tail_head_plain_matches_pallas_interpret(h0, w0):
    """The head form, bf16, against ``fused_ms_tail_head(impl="interpret")``:
    4 bf16 ulps of the largest logit, for the reasons above plus the bf16
    rounding of the activation ahead of the 1x1 and of the logits at the
    end."""
    from mtt_tpu.kernels.invpt_tail import fused_ms_tail_head as jtail
    from mtt_tpu_torch.kernels.invpt_tail import fused_ms_tail_head

    xs, kc, inv, addv, wh, bh = _tail_inputs(h0, w0, 16, 136, 7, seed=2, B=1)
    th, tw = 8 * h0, 8 * w0
    bf = jnp.bfloat16
    want = jtail(tuple(_j(x, bf) for x in xs), _j(kc), _j(inv), _j(addv),
                 _j(wh), _j(bh), th, tw, impl="interpret")
    got = fused_ms_tail_head(tuple(_t(x, torch.bfloat16) for x in xs), _t(kc),
                             _t(inv), _t(addv), _t(wh), _t(bh), th, tw)
    assert got.shape == (1, th, tw, 7) and got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), 4 * 2.0 ** -7)


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("h0,w0", GRIDS)
def test_ms_tail_stage_plains_compose_to_the_tail(h0, w0, head):
    """The card runs the tail as Gm on the shared GEMM (one launch a scale)
    and the mix kernel; their plain versions, composed, give the bits in
    bf16 of the one-piece factored tail (each scale's Gm, width and height
    mixes in turn, summed), written out here, with and without the head;
    each Gm has the (B, gh, gw, 3, 3, D) layout the mix kernel reads."""
    from mtt_tpu_torch.kernels.invpt_tail import (_shift_stack,
                                                  ms_tail_gm_plain,
                                                  ms_tail_head_plain,
                                                  ms_tail_mix_plain,
                                                  ms_tail_plain)

    xs, kc, inv, addv, wh, bh = _tail_inputs(h0, w0, 24, 40, 5, seed=5)
    bf = torch.bfloat16
    xs = tuple(_t(x, bf) for x in xs)
    kc, inv, addv, wh, bh = map(_t, (kc, inv, addv, wh, bh))
    th, tw = 8 * h0, 8 * w0
    gms = ms_tail_gm_plain(xs, kc)
    for x, gm in zip(xs, gms):
        assert gm.shape == (*x.shape[:3], 3, 3, 40) and gm.dtype == bf
    Wf = kc.to(bf).permute(2, 0, 1, 3).reshape(24, 9 * 40)
    Y = 0.0
    for x, f in zip(xs, (8, 4, 2)):
        b_, gh, gw, _ = x.shape
        G6 = torch.matmul(x.reshape(-1, 24), Wf).reshape(b_, gh, gw, 3, 3,
                                                         40)
        M = torch.einsum("bhwkld,wlW->bhkWd", G6,
                         torch.from_numpy(_shift_stack((gw, f))).to(bf))
        Y = Y + torch.einsum("bhkWd,hkH->bHWd", M.float(),
                             torch.from_numpy(_shift_stack((gh, f))))
    act = torch.relu(Y * inv + addv).to(bf)
    if head:
        want = torch.matmul(act.float(), wh.to(bf).float()) + bh
        got = ms_tail_mix_plain(gms, inv, addv, th, tw, wh, bh)
        assert torch.equal(ms_tail_head_plain(xs, kc, inv, addv, wh, bh, th,
                                              tw), want)
    else:
        want = act
        got = ms_tail_mix_plain(gms, inv, addv, th, tw)
        assert torch.equal(ms_tail_plain(xs, kc, inv, addv, th, tw), want)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("g,f", [(2, 8), (14, 8), (16, 8), (18, 8), (28, 4),
                                 (32, 4), (56, 2), (64, 2)])
def test_ms_tail_bands_have_two_taps_per_output(g, f):
    """The mix kernel reads two of the three band entries of each output row
    or column per conv tap (csrc/invpt_tail.cu: tap_base): for output f s +
    p and tap k the upsampled position p + k - 1 lies (2 (p + k - 1) + 1 -
    f) / (2 f) low-res rows from s, between s - 1 and s when negative, else
    between s and s + 1. The third entry is exactly 0, at the map's borders
    too; away from them (1 <= s <= g - 2) the two weights are the bilinear
    multiples of 1 / (2 f) the kernel uses as constants (tap_weight)."""
    from mtt_tpu_torch.kernels.invpt_tail import _bands

    band = _bands((g, f))                              # (f g, tap, 3)
    for W in range(f * g):
        p = W % f
        for k in range(3):
            pos = 2 * (p + k - 1) + 1 - f
            base = 0 if pos < 0 else 1
            assert band[W, k, 2 - 2 * base] == 0.0, (W, k, band[W, k])
            if 1 <= W // f <= g - 2:
                a = pos + 2 * f if pos < 0 else pos
                assert band[W, k, base] == (2 * f - a) / (2 * f), (W, k)
                assert band[W, k, base + 1] == a / (2 * f), (W, k)


def test_ms_tail_backward_matches_jax_grad():
    """The tail's backward (autograd through the dense twin) against
    ``jax.grad`` of ``fused_ms_tail``, f32, non-square grid: the gradients of
    the three maps, the conv kernel, inv and addv to 1e-4 of their scale."""
    from mtt_tpu.kernels.invpt_tail import fused_ms_tail as jtail
    from mtt_tpu_torch.kernels.invpt_tail import fused_ms_tail

    xs, kc, inv, addv, _, _ = _tail_inputs(2, 3, 12, 10, 1, seed=3)
    th, tw = 16, 24
    cot = np.random.default_rng(4).normal(size=(2, th, tw, 10)).astype(
        np.float32)
    want = jax.grad(
        lambda x0, x1, x2, k, i, a: (jtail((x0, x1, x2), k, i, a, th, tw,
                                           impl="xla") * cot).sum(),
        argnums=tuple(range(6)))(*map(_j, (*xs, kc, inv, addv)))
    ts = [_t(x).requires_grad_() for x in (*xs, kc, inv, addv)]
    (fused_ms_tail(tuple(ts[:3]), *ts[3:], th, tw) * _t(cot)).sum().backward()
    for i, g in enumerate(want):
        _close(ts[i].grad, g, 1e-4, f"grad {i}")


def test_ms_tail_wrapper_refuses():
    """What the JAX wrapper does not send to its kernel raises here: channel
    mismatches, non-integer or unequal factors, more than 128 logits; the
    head form has no backward; the kernel path refuses other dtypes and
    factors than (8, 4, 2) before any launch."""
    from mtt_tpu_torch.kernels.invpt_tail import (fused_ms_tail,
                                                  fused_ms_tail_head,
                                                  ms_tail_cuda)
    xs, kc, inv, addv, wh, bh = _tail_inputs(2, 2, 8, 8, 3)
    xs = tuple(map(_t, xs))
    kc, inv, addv, wh, bh = map(_t, (kc, inv, addv, wh, bh))
    with pytest.raises(ValueError, match="share"):
        fused_ms_tail((xs[0], xs[1], xs[2][..., :4]), kc, inv, addv, 16, 16)
    with pytest.raises(ValueError, match="integer factor"):
        fused_ms_tail(xs, kc, inv, addv, 16, 32)
    with pytest.raises(ValueError, match="integer factor"):
        fused_ms_tail(xs, kc, inv, addv, 20, 20)
    with pytest.raises(ValueError, match="128 logits"):
        fused_ms_tail_head(xs, kc, inv, addv, torch.zeros(8, 129),
                           torch.zeros(129), 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ms_tail(xs, kc, inv, addv, 16, 16, impl="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        ms_tail_cuda(xs, kc, inv, addv, 16, 16)
    xb = tuple(x.bfloat16() for x in xs)
    with pytest.raises(ValueError, match="factors"):
        ms_tail_cuda(xb, kc, inv, addv, 32, 32)
    logits = fused_ms_tail_head(tuple(x.requires_grad_() for x in xs), kc,
                                inv, addv, wh, bh, 16, 16)
    with pytest.raises(NotImplementedError, match="eval-only"):
        logits.sum().backward()
