"""Float32, JAX's default dtype: the port against the JAX package at f32.

The card runs the TaskPrompter-ViT eval forward at f32 through the f32
forms of rows 1-6 (and of rows 13 and 14, which the module API reaches);
those forms are held to their plain versions on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phase 23). Here, on the CPU,
each wrapper's plain version at f32 is held to the JAX function at f32 at
ViT-T widths (C = 64, 4 heads of 16, hidden 256; the task decode and the
head at the ViT-T test configs' tar 24 and F 28): the Pallas kernel in
interpret mode where its gate admits the shape, the XLA twin JAX falls back
to where it does not. Everything is f32, so the two sides differ in the
order of their f32 sums. Relative RMS error 1e-5 for every row, and 2e-7
for the up4 head: JAX's gate sends f32 to its XLA twin ``_head_xla``, which
takes the A&S erf GELU, and so does the port's f32 head (kernel and plain
version); the port's head sits 1.5e-7 from it on these inputs, where the TPU
kernel's fast polynomial (|err| <= 2.1e-4 pointwise), which the port's f32
head took before, read 6e-7. The f32 cases of these rows
at other widths (C = 128 and 256, head dim 64) are
tests/test_torch_kernels.py's and tests/test_torch_head.py's, not repeated
here; the inference CLI at its f32 default is tests/test_torch_inference.py's.

Then the card's dtype gate (``utils/precision.py: check_card_dtype``) for
every shipped config and run mode, and JAX's ``--trained_model`` on the
port's ``main`` command line.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_threads import torch_threads  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOL = 1e-5
# the up4 head at f32: twice the distance measured with the A&S erf GELU
# (1.5e-7), at most 2e-7; the fast polynomial GELU reads 6e-7
TOL_ROW = {"6": 2e-7}
# ViT-T: embed 64, 4 heads of 16, MLP hidden 256; 2 images of 36 tokens
# plus 1 prompt; the decode at tar 24, F 28 over a 6x6 grid, 3 tasks
B, N, C, H, HID = 2, 37, 64, 4, 256
T, TAR, FIN, GH = 3, 24, 28, 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _row(row, rng):
    """(port output, JAX output) of one row at f32 on seeded inputs."""
    from mtt_tpu.kernels import attention as ja
    from mtt_tpu.kernels import head_up4 as jh
    from mtt_tpu.kernels import layernorm as jl
    from mtt_tpu.kernels import mlp as jm
    from mtt_tpu.kernels import task_decode as jd
    from mtt_tpu_torch.kernels import attention as ta
    from mtt_tpu_torch.kernels import head_up4 as th
    from mtt_tpu_torch.kernels import layernorm as tl
    from mtt_tpu_torch.kernels import mlp as tm
    from mtt_tpu_torch.kernels import task_decode as td

    def r(*shape, s=1.0, m=0.0):
        return (m + s * rng.normal(size=shape)).astype(np.float32)

    x, g, b = r(B, N, C), r(C, s=0.1, m=1.0), r(C, s=0.1)
    J = jnp.asarray
    if row == "3":
        return (tl.fused_layernorm(_t(x), _t(g), _t(b)),
                jl.fused_layernorm(J(x), J(g), J(b), impl="interpret"))
    if row in ("1", "2"):
        w, bq = r(C, 3 * C, s=C ** -0.5), r(3 * C, s=0.1)
        emit = row == "2"
        got = ta.fused_attention_ln_qkv(_t(x), _t(g), _t(b), _t(w.T), _t(bq),
                                        H, need_qkv=emit)
        want = ja.fused_attention_ln_qkv(J(x), J(g), J(b), J(w), J(bq), H,
                                         need_qkv=emit, impl="interpret")
        return (torch.cat([o.reshape(-1) for o in got]) if emit else got,
                np.concatenate([np.asarray(o).reshape(-1) for o in want])
                if emit else want)
    if row == "4":
        w1, b1 = r(C, HID, s=C ** -0.5), r(HID, s=0.1)
        w2, b2 = r(HID, C, s=HID ** -0.5), r(C, s=0.1)
        return (tm.fused_mlp_ln_res(_t(x), _t(g), _t(b), _t(w1.T), _t(b1),
                                    _t(w2.T), _t(b2)),
                jm.fused_mlp_ln_res(*map(J, (x, g, b, w1, b1, w2, b2)),
                                    impl="interpret"))
    if row == "5":
        S, G = GH * GH, H
        args = (r(B, S, C), r(B, T, S, G), r(B, T, C),
                r(T, C, TAR, s=C ** -0.5), r(T, TAR, s=0.1),
                r(T, C, TAR, s=C ** -0.5), r(T, TAR, s=0.1),
                r(T, 2 * TAR, FIN, s=(2 * TAR) ** -0.5), r(T, FIN, s=0.1))
        xs, a, cw, ws, bs, wc, bc, wf, bf = args
        return (td.fused_task_decode(
                    _t(xs), _t(a), _t(cw), _t(ws.transpose(0, 2, 1)), _t(bs),
                    _t(wc.transpose(0, 2, 1)), _t(bc),
                    _t(wf.transpose(0, 2, 1)), _t(bf)),
                jd.fused_task_decode(*map(J, args), impl="interpret"))
    if row == "6":
        hx, kc = r(B, GH, GH, FIN, s=0.5), r(3, 3, FIN, FIN,
                                            s=(9 * FIN) ** -0.5)
        inv, addv, kp = r(FIN, s=0.1, m=1.0), r(FIN, s=0.1), r(FIN, 5,
                                                              s=FIN ** -0.5)
        return (th.fused_up4_head(*map(_t, (hx, kc, inv, addv, kp))),
                jh.fused_up4_head(*map(J, (hx, kc, inv, addv, kp)),
                                  impl="interpret"))
    if row == "13":
        qkv = r(B, N, 3 * C, s=1.5)
        return (ta.fused_attention_qkv(_t(qkv), H),
                ja.fused_attention_qkv(J(qkv), H, (C // H) ** -0.5,
                                       impl="interpret"))
    if row == "14":
        q, k, v = r(B, N, H, C // H, s=2.0), r(B, 9, H, C // H), \
            r(B, 9, H, C // H)
        return (ta.fused_attention(_t(q), _t(k), _t(v)),
                ja.fused_attention(J(q), J(k), J(v), impl="interpret"))
    raise ValueError(row)


@pytest.mark.parametrize("row", ["1", "2", "3", "4", "5", "6", "13", "14"])
def test_plain_f32_matches_jax_at_vit_t(row, monkeypatch):
    """Each row's plain version at f32 (the CPU's path, the card's
    reference) against the JAX function at f32: relative RMS 1e-5; the up4
    head 2e-7 (its GELU is JAX's f32 head's)."""
    monkeypatch.delenv("MTT_ATTN_SAFE_SOFTMAX", raising=False)
    got, want = _row(row, np.random.default_rng(int(row)))
    assert got.dtype == torch.float32
    err = _rel(got.numpy(), np.asarray(want, np.float32))
    assert err <= TOL_ROW.get(row, TOL), (row, err)


def _shipped():
    return sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yml"),
                            recursive=True))


@pytest.mark.parametrize("run_mode", ["train", "infer"])
@pytest.mark.parametrize("path", _shipped(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_card_dtype_gate_for_every_shipped_config(path, run_mode):
    """bf16 is taken everywhere; f32 only for the eval forward of the
    TaskPrompter-ViT configs (PASCAL ViT-L and ViT-B, NYUD ViT-L); f32
    training and InvPT or Swin at f32 raise naming ROADMAP.md item 1.14;
    another dtype raises."""
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.utils.precision import check_card_dtype
    p = create_config(path, {"run_mode": "infer"})
    check_card_dtype(p, run_mode, torch.bfloat16)
    vit_tp = p["model"] == "TaskPrompter" and "vit" in p["backbone"]
    if run_mode == "infer" and vit_tp:
        check_card_dtype(p, run_mode, torch.float32)
    else:
        with pytest.raises(ValueError, match="item 1.14"):
            check_card_dtype(p, run_mode, torch.float32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        check_card_dtype(p, run_mode, torch.float16)


def test_card_dtype_gate_takes_the_three_vit_configs():
    """Of the six shipped configs, exactly PASCAL ViT-L and ViT-B and NYUD
    ViT-L run their eval forward at f32 on the card."""
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.utils.precision import check_card_dtype
    taken = []
    for path in _shipped():
        try:
            check_card_dtype(create_config(path, {"run_mode": "infer"}),
                             "infer", torch.float32)
            taken.append(os.path.relpath(path, os.path.join(REPO,
                                                            "configs")))
        except ValueError:
            pass
    assert taken == ["nyud/taskprompter_vitLp16.yml",
                     "pascal/taskprompter_vitBp16.yml",
                     "pascal/taskprompter_vitLp16.yml"]


@pytest.mark.parametrize("src,tar,fin,taken", [
    (("pascal", "taskprompter_vitLp16.yml"), 768, 768, False),
    (("pascal", "taskprompter_vitLp16.yml"), 304, 352, True),
    (("pascal", "taskprompter_vitLp16.yml"), 308, 350, False),
    (("pascal", "taskprompter_vitBp16.yml"), 300, 354, False),
    (("nyud", "taskprompter_vitLp16.yml"), 768, 768, True),
], ids=["vitL-768", "vitL-304-352", "vitL-tar308", "vitB-F354",
        "nyud-768-windowed"])
def test_card_dtype_gate_refuses_the_split_decode_at_f32(tmp_path, src, tar,
                                                         fin, taken):
    """A TaskPrompter-ViT YAML whose decode runs the one-launch kernel past
    its tar 304 / F 352 (the split form, bf16 only) is refused at f32 before
    anything is built, naming item 1.14; bf16 takes it. NYUD's windowed
    decode runs in torch at any width."""
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.utils.precision import check_card_dtype
    with open(os.path.join(REPO, "configs", *src)) as f:
        text = f.read()
    for key, old, new in (("embed_dim", "300", tar),
                          ("final_embed_dim", "350", fin)):
        if src[0] == "nyud":
            old = "768"
        line = f"\n{key}: {old}\n"
        assert line in text, line
        text = text.replace(line, f"\n{key}: {new}\n")
    yml = tmp_path / "exp.yml"
    yml.write_text(text)
    p = create_config(str(yml), {"run_mode": "infer"})
    assert (p["embed_dim"], p["final_embed_dim"]) == (tar, fin)
    check_card_dtype(p, "infer", torch.bfloat16)
    if taken:
        check_card_dtype(p, "infer", torch.float32)
    else:
        with pytest.raises(ValueError, match="split form.*item 1.14"):
            check_card_dtype(p, "infer", torch.float32)


def test_exact_f32_turns_tf32_off_and_puts_it_back():
    from mtt_tpu_torch.utils.precision import exact_f32
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with exact_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        with exact_f32(False):
            assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def test_main_parses_trained_model_as_jax_main_does():
    """JAX's main.py accepts --trained_model and reads it nowhere; the
    port's main accepts it too (and reads it nowhere), with JAX's other
    flags."""
    from mtt_tpu_torch.main import parse_args
    args = parse_args(["--config_exp", "exp.yml", "--run_mode", "infer",
                       "--trained_model", "ck/model.pt"])
    assert args.trained_model == "ck/model.pt"
    assert args.run_mode == "infer" and args.dtype == "bfloat16"
    assert parse_args(["--config_exp", "exp.yml"]).trained_model is None
