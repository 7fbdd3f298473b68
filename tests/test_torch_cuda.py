"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and nvcc; without one they skip. On a machine
with a card and no JAX, run them without the repository's conftest (which
imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Shapes are small but ragged (row, query and key counts that are not tile
multiples). Inputs are bf16 from a seeded torch.Generator. Tolerance: a few
bf16 ulps of the largest reference value, because kernel and plain version
round at the same points but sum in another order, which can flip a rounding.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device="cuda") * std
            + mean).to(dtype)


def _check(got, want, ulps=4):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g).all()
        tol = ulps * w.float().abs().max().item() * 2.0 ** -7
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("shape", [(3, 37, 1024), (5, 64), (2, 9, 1536)])
def test_layernorm_kernel(gen, shape):
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    C = shape[-1]
    x = _rnd(gen, *shape)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=torch.float32)
    b = _rnd(gen, C, std=0.1, dtype=torch.float32)
    _check(fused_layernorm(x, g, b), fused_layernorm(x, g, b, impl="plain"),
           ulps=1)


@pytest.mark.parametrize("need_qkv", [False, True])
@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("N", [77, 128])
def test_attention_kernels(gen, need_qkv, safe, N):
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
    B, H, D = 2, 4, 64
    C = H * D
    x = _rnd(gen, B, N, C)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=torch.float32)
    b = _rnd(gen, C, std=0.1, dtype=torch.float32)
    w = _rnd(gen, 3 * C, C, std=C ** -0.5)
    bq = _rnd(gen, 3 * C, std=0.1)
    args = (x, g, b, w, bq, H)
    _check(fused_attention_ln_qkv(*args, need_qkv=need_qkv, safe=safe),
           fused_attention_ln_qkv(*args, need_qkv=need_qkv, safe=safe,
                                  impl="plain"))


@pytest.mark.parametrize("C", [768, 1024])
def test_mlp_kernel(gen, C):
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res
    Hd = 384
    x = _rnd(gen, 3, 15, C)
    g = _rnd(gen, C, std=0.1, mean=1.0, dtype=torch.float32)
    b = _rnd(gen, C, std=0.1, dtype=torch.float32)
    w1, b1 = _rnd(gen, Hd, C, std=C ** -0.5), _rnd(gen, Hd, std=0.1)
    w2, b2 = _rnd(gen, C, Hd, std=Hd ** -0.5), _rnd(gen, C, std=0.1)
    args = (x, g, b, w1, b1, w2, b2)
    _check(fused_mlp_ln_res(*args), fused_mlp_ln_res(*args, impl="plain"))


@pytest.mark.parametrize("S,tar,fin", [(50, 300, 350), (64, 16, 40)])
def test_task_decode_kernel(gen, S, tar, fin):
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode
    B, C, T, G = 2, 256, 3, 4
    args = (_rnd(gen, B, S, C), _rnd(gen, B, T, S, G),
            _rnd(gen, B, T, C, dtype=torch.float32),
            _rnd(gen, T, tar, C, std=C ** -0.5), _rnd(gen, T, tar, std=0.1),
            _rnd(gen, T, tar, C, std=C ** -0.5), _rnd(gen, T, tar, std=0.1),
            _rnd(gen, T, fin, 2 * tar, std=(2 * tar) ** -0.5),
            _rnd(gen, T, fin, std=0.1))
    _check(fused_task_decode(*args), fused_task_decode(*args, impl="plain"))


def test_model_goes_through_kernels(gen):
    """TaskPrompter-ViT-B (C=768, D=64) at 64x64 in bf16: every kernel of
    the path launches, and the logits' relative RMS error against an f32 run
    of the same weights stays within 0.1 (bf16 rounding through random
    weights; a wiring fault gives errors of order 1; as in chip_smoke.py)."""
    import copy

    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet

    tasks = ("semseg", "edge")
    model = TaskPrompterNet(tasks, {"semseg": 21, "edge": 1}, (64, 64),
                            "TaskPrompter_vitB", device="cuda",
                            dtype=torch.bfloat16).eval()
    init_weights(model, gen)
    x = torch.randn(2, 64, 64, 3, generator=gen, device="cuda")
    _build.reset_counts()
    logits, preds = predict(model, x)
    torch.cuda.synchronize()
    assert _build.COUNTS == {"layernorm": 4 + 1, "attention_cached": 8,
                             "attention_emit": 4, "mlp": 12, "task_decode": 4}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref, _ = predict(copy.deepcopy(model).float(), x, impl="plain")
    for t in tasks:
        assert logits[t].shape == ref[t].shape
        assert preds[t].shape == (2, 64, 64)
        r = ref[t].float()
        err = ((logits[t].float() - r).norm() / r.norm()).item()
        assert err <= 0.1, (t, err)
