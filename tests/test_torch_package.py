"""The PyTorch port as a package: it imports no JAX, refuses what the JAX
package refuses, and its kernel wrappers check their arguments before they
dispatch, so bad input raises on the CPU too."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_package_imports_no_jax():
    """Importing every mtt_tpu_torch module leaves no jax, flax or mtt_tpu
    in sys.modules (the card's machine has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mtt_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    mtt_tpu_torch.__path__, 'mtt_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'mtt_tpu'))\n"
        "assert len(mods) >= 36, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_refuses_prompt_len_above_one():
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet
    with pytest.raises(NotImplementedError, match="prompt_len"):
        TaskPrompterNet(("semseg",), {"semseg": 5}, (32, 32),
                        "TaskPrompter_vitT", tar_dim=8, final_dim=8,
                        prompt_len=2, device="meta")


def test_refuses_windowed_channel_decode_and_other_heads():
    """The windowed channel decode builds now (NYUD's chan_nheads 16); the
    ``phase`` up4 head still raises with its ROADMAP item."""
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet
    model = TaskPrompterNet(("semseg",), {"semseg": 5}, (32, 32),
                            "TaskPrompter_vitT", tar_dim=8, final_dim=8,
                            chan_nheads=4, device="meta")
    assert model.backbone.decode_0.chan_windows == (2, 2)
    from mtt_tpu_torch.models.heads import ConvHead
    with pytest.raises(NotImplementedError, match="up4.*ROADMAP"):
        ConvHead(8, 5, up4="phase", device="meta")
    for mode in ("factored", "dense"):
        assert ConvHead(8, 5, up4=mode, device="meta").up4 == mode


@pytest.mark.parametrize("hw", [(40, 32), (32, 20)])
def test_refuses_size_not_divisible_by_patch(hw):
    from mtt_tpu_torch.models.layers import PatchEmbed
    with pytest.raises(ValueError, match="divisible"):
        PatchEmbed(16, 8)(torch.zeros(1, *hw, 3))


def _attn_args(C=64, heads=2):
    x = torch.randn(2, 5, C)
    return [x, torch.ones(C), torch.zeros(C), torch.randn(3 * C, C),
            torch.zeros(3 * C)], heads


def test_attention_wrapper_checks_arguments():
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
    args, heads = _attn_args()
    fused_attention_ln_qkv(*args, heads)                  # well-formed
    bad_w = args.copy()
    bad_w[3] = torch.randn(3 * 64, 32)
    with pytest.raises(ValueError):
        fused_attention_ln_qkv(*bad_w, heads)
    noncontig = args.copy()
    noncontig[0] = torch.randn(2, 64, 5).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention_ln_qkv(*noncontig, heads)
    with pytest.raises(ValueError):
        fused_attention_ln_qkv(*args, 5)                  # 3C % (3 * 5)
    ints = args.copy()
    ints[0] = torch.zeros(2, 5, 64, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_attention_ln_qkv(*ints, heads)


def test_wrappers_refuse_cuda_impl_on_cpu_tensors():
    """The plain version runs only for CPU tensors or when asked for; a
    request for the kernel on a CPU tensor raises instead of falling back."""
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    x = torch.randn(3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_layernorm(x, torch.ones(8), torch.zeros(8), impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        fused_layernorm(x, torch.ones(8), torch.zeros(8), impl="xla")


def test_layernorm_and_mlp_wrappers_check_shapes():
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res
    x = torch.randn(2, 3, 8)
    with pytest.raises(ValueError):
        fused_layernorm(x, torch.ones(7), torch.zeros(8))
    with pytest.raises(TypeError):
        fused_layernorm(x.long(), torch.ones(8), torch.zeros(8))
    w1, w2 = torch.randn(32, 8), torch.randn(8, 32)
    fused_mlp_ln_res(x, torch.ones(8), torch.zeros(8), w1, torch.zeros(32),
                     w2, torch.zeros(8))
    with pytest.raises(ValueError):
        fused_mlp_ln_res(x, torch.ones(8), torch.zeros(8), w1,
                         torch.zeros(32), w2.t(), torch.zeros(8))
    with pytest.raises(TypeError):
        fused_mlp_ln_res(x, torch.ones(8), torch.zeros(8), w1.double(),
                         torch.zeros(32), w2, torch.zeros(8))


def test_kernel_parameter_flags_and_alignment():
    """The row 3 and row 4 kernels read f32 or bf16 parameters as stored
    (one flag bit each, no cast), refuse other dtypes, and refuse data that
    does not start on a 16-byte boundary."""
    from mtt_tpu_torch.kernels import _build
    f32, bf = torch.ones(8), torch.ones(8, dtype=torch.bfloat16)
    assert _build.param_flags(f32, bf, bf, f32) == 0b1001
    assert _build.param_flags(bf, bf) == 0
    with pytest.raises(TypeError):
        _build.param_flags(f32, f32.double())
    buf = torch.zeros(65, dtype=torch.bfloat16)
    _build.check_aligned("x", buf[:64], buf[8:])
    with pytest.raises(ValueError, match="aligned"):
        _build.check_aligned("x", buf[1:])


@pytest.mark.parametrize("C,Hd", [(12, 48), (16, 36), (8, 4)])
def test_gemm_wrappers_refuse_widths_and_unaligned_data(C, Hd):
    """Row 8 and the qkv projection run on the shared GEMM, which reads its
    operands with TMA: any row count, widths that are positive multiples of
    8 and 16-byte aligned data, else a ValueError that names the limit,
    raised on the CPU before any launch."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.attention import qkv_proj_cuda
    from mtt_tpu_torch.kernels.mlp import mlp_fc_cuda
    bf = torch.bfloat16
    x = torch.zeros(5, C, dtype=bf)
    w1, w2 = torch.zeros(Hd, C, dtype=bf), torch.zeros(C, Hd, dtype=bf)
    with pytest.raises(ValueError, match="multiple of 8"):
        mlp_fc_cuda(x, w1, torch.zeros(Hd), w2, torch.zeros(C))
    with pytest.raises(ValueError, match="multiple of 8"):
        qkv_proj_cuda(x, w1, torch.zeros(Hd))
    _build.check_gemm_widths("the GEMM", C=8, hidden=4096)
    buf = torch.zeros(5 * 16 + 1, dtype=bf)
    xv = buf[1:].view(5, 16)
    w1, w2 = torch.zeros(64, 16, dtype=bf), torch.zeros(16, 64, dtype=bf)
    with pytest.raises(ValueError, match="aligned"):
        mlp_fc_cuda(xv, w1, torch.zeros(64), w2, torch.zeros(16))
    with pytest.raises(ValueError, match="aligned"):
        qkv_proj_cuda(xv, w1, torch.zeros(64))


def test_task_decode_wrapper_checks_shapes():
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode
    B, S, C, T, G, tar, F = 1, 4, 16, 2, 4, 6, 5
    args = [torch.randn(B, S, C), torch.randn(B, T, S, G),
            torch.randn(B, T, C), torch.randn(T, tar, C), torch.randn(T, tar),
            torch.randn(T, tar, C), torch.randn(T, tar),
            torch.randn(T, F, 2 * tar), torch.randn(T, F)]
    assert fused_task_decode(*args).shape == (B, S, T * F)
    for i, bad in [(1, torch.randn(B, T, S, 3)),       # G does not divide C
                   (7, torch.randn(T, F, tar)),        # wf not (T, F, 2 tar)
                   (4, torch.randn(T, tar + 1))]:
        broken = args.copy()
        broken[i] = bad
        with pytest.raises(ValueError):
            fused_task_decode(*broken)


@pytest.mark.parametrize("C,G,tar,fin", [(12, 3, 8, 10), (64, 16, 8, 10),
                                         (64, 4, 6, 10), (64, 4, 308, 10),
                                         (64, 4, 8, 7), (64, 4, 8, 354)])
def test_task_decode_kernel_refuses_widths_before_launch(C, G, tar, fin):
    """The kernel reads x and the weights with TMA (16-byte row pitches) and
    splits tar and F over two warpgroups' products: C and C / G multiples of
    8, tar % 4 == 0 up to 304, F even up to 352, else a ValueError that
    names the limits, raised on the CPU before any launch; so are data not
    on a 16-byte boundary and biases of two dtypes."""
    from mtt_tpu_torch.kernels.task_decode import (check_task_decode_widths,
                                                   task_decode_cuda)
    bf = torch.bfloat16
    B, S, T = 1, 4, 2

    def args(C, G, tar, fin):
        return [torch.zeros(B, S, C, dtype=bf), torch.zeros(B, T, S, G),
                torch.zeros(B, T, C), torch.zeros(T, tar, C, dtype=bf),
                torch.zeros(T, tar), torch.zeros(T, tar, C, dtype=bf),
                torch.zeros(T, tar), torch.zeros(T, fin, 2 * tar, dtype=bf),
                torch.zeros(T, fin)]

    with pytest.raises(ValueError, match="task-decode kernel needs"):
        task_decode_cuda(*args(C, G, tar, fin))
    check_task_decode_widths(1024, 16, 300, 350)
    check_task_decode_widths(768, 16, 304, 352)
    good = args(64, 4, 8, 10)
    buf = torch.zeros(B * S * 64 + 1, dtype=bf)
    unaligned = [buf[1:].view(B, S, 64), *good[1:]]
    with pytest.raises(ValueError, match="aligned"):
        task_decode_cuda(*unaligned)
    good[4] = good[4].to(bf)
    with pytest.raises(TypeError, match="share a dtype"):
        task_decode_cuda(*good)


def test_up4_head_kernel_checks_before_launch():
    """The head's grid and logit limits in one function the CPU can call,
    and data not on a 16-byte boundary raise before any launch (the Gm
    launch reads x with TMA)."""
    from mtt_tpu_torch.kernels.head_up4 import (MAX_LOGITS,
                                                check_head_up4_shape,
                                                head_up4_cuda)
    check_head_up4_shape(32, 32, 21)
    check_head_up4_shape(28, 36, MAX_LOGITS)
    for gh, gw, n in ((4, 8, 1), (8, 10, 1), (8, 8, MAX_LOGITS + 1)):
        with pytest.raises(ValueError, match="up4 head kernel"):
            check_head_up4_shape(gh, gw, n)
    bf = torch.bfloat16
    buf = torch.zeros(8 * 8 * 16 + 1, dtype=bf)
    xv = buf[1:].view(1, 8, 8, 16)
    with pytest.raises(ValueError, match="aligned"):
        head_up4_cuda(xv, torch.zeros(3, 3, 16, 16, dtype=bf), torch.ones(16),
                      torch.zeros(16), torch.zeros(16, 5, dtype=bf))


def test_tail_and_window_kernels_check_before_launch():
    """The limits of rows 10 and 11 in functions the CPU can call, and data
    not on a 16-byte boundary raise before any launch (the tail's Gm launch
    reads the maps with TMA)."""
    from mtt_tpu_torch.kernels.invpt_tail import (MAX_LOGITS,
                                                  check_ms_tail_shape,
                                                  ms_tail_cuda)
    from mtt_tpu_torch.kernels.window_attention import (
        BWD_MAX_TOKENS, check_window_attention_shape)
    check_ms_tail_shape((8, 4, 2))
    check_ms_tail_shape((8, 4, 2), MAX_LOGITS)
    with pytest.raises(ValueError, match="factors"):
        check_ms_tail_shape((4, 2, 1))
    with pytest.raises(ValueError, match="at most 128 logits"):
        check_ms_tail_shape((8, 4, 2), MAX_LOGITS + 1)
    for m in (1, 147, 160, 400):
        check_window_attention_shape(m, 32)
    check_window_attention_shape(BWD_MAX_TOKENS, 32, backward=True)
    with pytest.raises(ValueError, match="shared memory"):
        check_window_attention_shape(BWD_MAX_TOKENS + 1, 32, backward=True)
    with pytest.raises(ValueError, match="head dim 32"):
        check_window_attention_shape(147, 64)
    with pytest.raises(ValueError, match="needs tokens"):
        check_window_attention_shape(0, 32)
    bf = torch.bfloat16
    xs = [torch.zeros(1, 2 * m, 2 * m, 16, dtype=bf) for m in (1, 2, 4)]
    buf = torch.zeros(4 * 16 + 1, dtype=bf)
    xs[0] = buf[1:].view(1, 2, 2, 16)
    with pytest.raises(ValueError, match="aligned"):
        ms_tail_cuda(xs, torch.zeros(3, 3, 16, 24, dtype=bf),
                     torch.ones(24), torch.zeros(24), 16, 16)


def test_kernel_build_needs_no_card_to_import_and_hashes_sources():
    """Importing the build helper compiles nothing; the library path is
    keyed by the sources' hash."""
    from mtt_tpu_torch.kernels import _build
    assert _build.COUNTS.keys() == {"layernorm", "attention_cached",
                                    "attention_emit", "attention_qkv",
                                    "attention_generic", "attention_bwd",
                                    "mlp_ln_res", "mlp_fc", "task_decode",
                                    "head_up4", "invpt_attention",
                                    "invpt_tail", "invpt_tail_head",
                                    "window_attention",
                                    "window_attention_bwd"}
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "layernorm.cu", "attention.cu", "attention_generic.cu",
        "attention_bwd.cu", "gemm.cu", "mlp.cu",
        "task_decode.cu", "head_up4.cu", "invpt_attention.cu",
        "invpt_tail.cu", "window_attention.cu", "window_attention_bwd.cu"}


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device argument the model and the trainer build on the
    card; where there is none they raise instead of running on the CPU."""
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet, build_model
    from mtt_tpu_torch.train import PASCAL_VITL, train_steps
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = dict(PASCAL_VITL, backbone="TaskPrompter_vitT")
    for call in (lambda: build_model(p),
                 lambda: TaskPrompterNet(("semseg",), {"semseg": 5},
                                         (32, 32), "TaskPrompter_vitT"),
                 lambda: train_steps(p, 1, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = build_model(p, device="meta")
    assert next(model.parameters()).device.type == "meta"


@pytest.mark.parametrize("hw,n", [((4, 4), 5), ((8, 10), 5), ((8, 8), 129)])
def test_up4_head_kernel_refuses_other_grids(hw, n):
    """The kernel path takes the grids the JAX kernel admits and raises on
    the others before any launch (the plain version takes any grid)."""
    from mtt_tpu_torch.kernels.head_up4 import fused_up4_head, head_up4_cuda
    C = 16
    args = (torch.zeros(1, *hw, C), torch.zeros(3, 3, C, C), torch.ones(C),
            torch.zeros(C), torch.zeros(C, n))
    with pytest.raises(ValueError, match="up4 head kernel"):
        head_up4_cuda(*args)
    assert fused_up4_head(*args).shape == (1, 4 * hw[0], 4 * hw[1], n)


def test_training_kernel_wrappers_check_arguments():
    from mtt_tpu_torch.kernels.attention import attn_core_bwd_cuda
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    qkv = torch.zeros(2, 5, 3 * 2 * 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 64"):
        attn_core_bwd_cuda(qkv, torch.zeros(2, 5, 64, dtype=torch.bfloat16),
                           2, 0.125)
    x = torch.randn(2, 3, 8)
    w1, w2 = torch.randn(32, 8), torch.randn(8, 32)
    assert fused_mlp(x, w1, torch.zeros(32), w2, torch.zeros(8)).shape == \
        x.shape
    with pytest.raises(ValueError):
        fused_mlp(x, w1, torch.zeros(32), w2.t(), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp(x, w1, torch.zeros(32), w2, torch.zeros(8), impl="cuda")
