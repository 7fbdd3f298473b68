"""The port's weight ingestion (``models/convert.py``,
``models/convert_torch.py``, ``python -m mtt_tpu_torch.convert_checkpoint``)
against the JAX package's converters followed by ``state_dict_from_flax``.

The reference-layout checkpoints and the Google npz are the JAX tests'
synthetic ones (``tests/test_convert_torch.py``, ``test_convert_swin.py``,
``test_convert.py``): ViT-T at 64x64 with 4 heads, the tiny Swin with the
tiny FCOS3D head at 64x128. The ViT-T models' JAX variable trees are built
once (``random_variables``: numpy values over ``jax.eval_shape``) and
carried into the port with ``state_dict_from_flax``, so both routes start
from the same values. The tiny Swin's tree is the one the JAX mapper fills
(``tests/test_convert_swin.py`` holds that tree to the JAX model's init,
which takes 7-10 s to trace); the port's side is held to its model by a
strict load.

The converters only move tensors, so the two routes must agree bit for bit
(keys, shapes, dtypes and values). Where a position embedding is resampled
the port's numpy cubic stands against ``jax.image.resize`` at 1e-6 of the
embedding's largest value. The CLI's outputs stand against the JAX forward
of the converted variables at the forward-parity tests' tolerance
(``tests/test_torch_model.py``: 1e-5 of each task's largest logit, plus the
factored head's fast-GELU slack).
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_convert import make_npz
from test_convert_swin import (CHAN as SW_CHAN, DEPTHS as SW_DEPTHS,
                               E as SW_E, FIN as SW_FIN, HEADS as SW_HEADS,
                               NUM_OUT as SW_NUM_OUT, TAR as SW_TAR,
                               TASKS as SW_TASKS, WINDOW as SW_WINDOW,
                               make_swin_sd)
from test_convert_torch import (DEPTH, EMB, FIN, HEADS, NUM_OUT, PRED, TAR,
                                TASKS, make_invpt_sd, make_taskprompter_sd)
from test_torch_model import _gelu_poly_slack, random_variables
from torch_threads import torch_threads  # noqa: F401

IMG = (64, 64)
# the TaskPrompter fixture's semseg head widened to PASCAL's 21 classes, so
# that the same checkpoint also goes through the PASCAL config's CLI
TP_OUT = {"semseg": 21, "edge": 1}


def _taskprompter_sd(seed):
    rng = np.random.default_rng(seed)
    sd = make_taskprompter_sd(rng)
    sd["heads.semseg.linear_pred.weight"] = rng.normal(
        size=(21, FIN, 1, 1)).astype(np.float32) * 0.05
    sd["heads.semseg.linear_pred.bias"] = rng.normal(size=21).astype(
        np.float32) * 0.05
    return sd


def _build(kind):
    """(JAX model, its input, port model) of one model kind (Swin: no JAX
    model)."""
    if kind == "taskprompter":
        from mtt_tpu.models.wrappers import TaskPrompterNet as J
        from mtt_tpu_torch.models.wrappers import TaskPrompterNet as P
        kw = dict(tar_dim=TAR, final_dim=FIN, use_ctr=True, chan_nheads=1)
        return (J(tasks=TASKS, num_outputs=TP_OUT, drop_path_rate=0.0,
                  backbone_name="TaskPrompter_vitT", **kw),
                np.zeros((1, *IMG, 3), np.float32),
                P(TASKS, TP_OUT, IMG, "TaskPrompter_vitT", device="cpu", **kw))
    if kind == "invpt":
        from mtt_tpu.models.wrappers import TransformerNet as J
        from mtt_tpu_torch.models.wrappers import TransformerNet as P
        kw = dict(embed_dim=EMB, pred_out=PRED, mtt_downsample=2)
        return (J(tasks=TASKS, num_outputs=NUM_OUT, backbone_name="vitT",
                  **kw), np.zeros((1, *IMG, 3), np.float32),
                P(TASKS, NUM_OUT, IMG, "vitT", device="cpu", **kw))
    from test_torch_detection import tiny_det_cfg
    from mtt_tpu_torch.detection.det_params import default_det_params
    from mtt_tpu_torch.models.wrappers import TaskPrompterSwinNet as P
    return None, None, P(SW_TASKS, SW_NUM_OUT, (64, 128), device="cpu",
                         det_cfg=tiny_det_cfg(default_det_params, 6),
                         tar_dim=SW_TAR, final_dim=SW_FIN,
                         chan_embed_dim=SW_CHAN, target_size=(32, 64),
                         embed_dim=SW_E, depths=SW_DEPTHS,
                         num_heads=SW_HEADS, window_size=SW_WINDOW)


def _build_case(kind):
    """(JAX model, JAX variables, the port model, the port state dict of
    those variables, the reference checkpoint) of one model kind."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    jnet, x, port = _build(kind)
    sd = {"taskprompter": lambda: _taskprompter_sd(0),
          "invpt": lambda: make_invpt_sd(np.random.default_rng(1)),
          "swin": lambda: make_swin_sd(np.random.default_rng(7))}[kind]()
    if jnet is not None:
        jvars = random_variables(jnet, jnp.asarray(x), seed=3)
    else:
        jvars = {"params": {}, "batch_stats": {}}
        for col, path, v in _swin_mapper(sd).entries:
            node = jvars[col]
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = np.zeros_like(v)
    template = state_dict_from_flax(jvars)
    port.load_state_dict(template, strict=True)
    return jnet, jvars, port, template, sd


@pytest.fixture(scope="module")
def case():
    """``case(kind)``: ``_build_case`` of the kind, built once for the
    module, when a test first asks for it."""
    built = {}

    def get(kind):
        if kind not in built:
            built[kind] = _build_case(kind)
        return built[kind]
    return get


def _swin_mapper(sd):
    """The JAX mapper of the tiny Swin and its tiny FCOS3D head."""
    from mtt_tpu.models.convert_torch import map_taskprompter_swin
    return map_taskprompter_swin(
        sd, list(SW_TASKS), depths=SW_DEPTHS, num_outs=5, stacked_convs=3,
        cls_branch=(16, 8), reg_branch=((16,),) * 5, dir_branch=(16,),
        centerness_branch=(16,), scale_dim=4, n_fpn_in=4)


def _jax_full(kind, sd, jvars):
    """The JAX route's variables for a reference checkpoint."""
    from mtt_tpu.models import convert_torch as J
    if kind == "swin":
        return J.apply_entries(dict(jvars), _swin_mapper(sd))
    return J.convert_full_checkpoint(
        sd, dict(jvars), {"taskprompter": "TaskPrompter",
                          "invpt": "TransformerNet"}[kind], list(TASKS),
        DEPTH, heads=HEADS, use_ctr=True)


def _port_full(sd, port):
    from mtt_tpu_torch.models.convert_torch import convert_full_checkpoint
    return convert_full_checkpoint(sd, port)


def _flax_sd(jvars):
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    return state_dict_from_flax({"params": jvars["params"],
                                 "batch_stats": jvars.get("batch_stats", {})})


def _assert_bit_equal(got, want, skip=()):
    assert set(got) == set(want)
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


@pytest.mark.parametrize("kind", ["taskprompter", "invpt", "swin"])
def test_full_checkpoint_bit_equal_to_jax_route(kind, case):
    """``convert_full_checkpoint`` against JAX's ``convert_full_checkpoint``
    (Swin: ``map_taskprompter_swin`` with the tiny topology, then
    ``apply_entries``; the port reads the tasks, depth, heads and topology
    off the model) then ``state_dict_from_flax``: equal keys, shapes, dtypes
    and bits, and a strict load. The transposed convs reach the port
    unflipped."""
    _, jvars, port, _, sd = case(kind)
    got = _port_full(sd, port)
    _assert_bit_equal(got, _flax_sd(_jax_full(kind, sd, jvars)))
    port.load_state_dict(got, strict=True)
    deconv = {"invpt": ("decoder.scale_embed_0.weight",
                        "multi_task_decoder.scale_embed.0.weight"),
              "swin": ("head_semseg.deconv.weight",
                       "heads.semseg.mt_proj.0.weight")}.get(kind)
    if deconv:
        assert np.array_equal(got[deconv[0]].numpy(), sd[deconv[1]])


@pytest.mark.parametrize("npz_grid", [4, 6])
@pytest.mark.parametrize("kind", ["invpt", "taskprompter"])
def test_npz_backbone_matches_jax_route(kind, npz_grid, tmp_path, case):
    """``load_vit_npz`` (the nested-attention ViT of InvPT) and
    ``load_vit_npz_taskprompter`` (the block-level qkv of ``PromptedBlock``)
    against the JAX functions then ``state_dict_from_flax``: every key bit
    for bit, the untouched ones included; from a 6x6 pretraining grid the
    resampled position embedding within 1e-6."""
    from mtt_tpu.models import convert as J
    from mtt_tpu_torch.models import convert as P
    _, jvars, port, template, _ = case(kind)
    path, _ = make_npz(tmp_path, depth=DEPTH, C=64, grid=npz_grid)
    params = dict(jvars["params"])
    if kind == "invpt":
        params["backbone"] = J.load_vit_npz(path, params["backbone"], DEPTH,
                                            (4, 4), num_heads=HEADS)
        got = P.load_vit_npz(path, template, DEPTH, (4, 4), num_heads=HEADS)
    else:
        params["backbone"] = J.load_vit_npz_taskprompter(
            path, params["backbone"], DEPTH, (4, 4), num_heads=HEADS)
        got = P.load_vit_npz_taskprompter(path, template, DEPTH, (4, 4),
                                          num_heads=HEADS)
    want = _flax_sd({**jvars, "params": params})
    pos = "backbone.pos_embed"
    _assert_bit_equal(got, want, skip=(pos,) if npz_grid != 4 else ())
    err = (got[pos] - want[pos]).abs().max().item()
    assert err <= 1e-6 * want[pos].abs().max().item()
    assert not torch.equal(got["backbone.blocks_0.norm1.weight"],
                           template["backbone.blocks_0.norm1.weight"])
    port.load_state_dict(got, strict=True)


@pytest.mark.parametrize("kind", ["invpt", "taskprompter"])
def test_torch_backbone_matches_jax_route(kind, case):
    """``load_torch_backbone`` against the JAX function then
    ``state_dict_from_flax``, every key, with one pinned difference: JAX
    keeps the reference's (3, H, D) qkv rows, which its head-major
    attention misreads, where the port reorders them as
    ``convert_full_checkpoint`` does; so its backbone equals that of the
    full conversion."""
    from mtt_tpu.models import convert as J
    from mtt_tpu_torch.models.convert import (load_torch_backbone,
                                              qkv_rows_head_major)
    _, jvars, port, template, sd = case(kind)
    params = dict(jvars["params"])
    params["backbone"] = J.load_torch_backbone(sd, params["backbone"], DEPTH,
                                               (4, 4))
    want = _flax_sd({**jvars, "params": params})
    for k in want:
        if ".qkv." in k:
            want[k] = qkv_rows_head_major(want[k], HEADS)
    got = load_torch_backbone(sd, template, DEPTH, (4, 4), num_heads=HEADS)
    _assert_bit_equal(got, want)
    full = _port_full(sd, port)
    for k in got:
        if k.startswith("backbone.") and "decode_" not in k:
            assert torch.equal(got[k], full[k]), k


@pytest.mark.parametrize("g,grid", [(4, (6, 6)), (6, (4, 4)), (4, (4, 6))])
def test_resize_pos_embed_matches_jax_image_resize(g, grid):
    """The converters' resample (``vit.resize_pos_embed``, through
    ``fit_pos_embed``) against ``jax.image.resize(..., "cubic")`` (through
    the JAX converter's ``_resize_pos_embed_np``): up, down (where the
    antialias widening acts) and to a non-square grid; the cls row kept."""
    from mtt_tpu.models.convert import _resize_pos_embed_np
    from mtt_tpu_torch.models.convert import fit_pos_embed
    pos = np.random.default_rng(g).normal(
        size=(1, 1 + g * g, 8)).astype(np.float32)
    want = np.asarray(_resize_pos_embed_np(pos, grid, 1))
    got = fit_pos_embed(pos, want.shape, grid).numpy()
    assert got.shape == want.shape == (1, 1 + grid[0] * grid[1], 8)
    assert np.array_equal(got[:, :1], pos[:, :1])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _broken(fault, sd, port):
    """A checkpoint (or model) with one fault, and the name the error
    must give."""
    sd = dict(sd)
    if fault == "missing":
        key = "backbone.blocks.0.attn.qkv.bias"
        del sd[key]
    elif fault == "extra":
        key = "backbone.blocks.0.attn.extra.weight"
        sd[key] = np.zeros(3, np.float32)
    elif fault == "shape":
        key = "head_edge.linear_pred.weight"
        sd["heads.edge.linear_pred.weight"] = np.zeros((2, FIN, 1, 1),
                                                       np.float32)
    else:                                   # a model key nothing fills
        key = "backbone.blocks_0.extra"
        port = copy.deepcopy(port)
        port.backbone.blocks_0.register_buffer("extra", torch.zeros(3))
    return sd, port, key


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "unfilled"])
def test_conversion_fails_loudly(fault, case):
    """A reference key missing, a reference key left over, a shape that
    differs and a model key left unfilled each raise, naming the key."""
    from mtt_tpu_torch.models.convert_torch import convert_full_checkpoint
    _, _, port, _, sd = case("taskprompter")
    sd, port, key = _broken(fault, sd, port)
    with pytest.raises((KeyError, ValueError), match=key.replace(".", r"\.")):
        convert_full_checkpoint(sd, port)


def test_non_square_target_grid_raises_as_jax(case):
    """A position embedding whose shape differs from the model's is
    resampled to the square grid its token count gives; a model with 4x5
    tokens has none, and both packages refuse."""
    from mtt_tpu.models.convert_torch import convert_full_checkpoint as J
    from mtt_tpu_torch.models.convert_torch import convert_full_checkpoint
    _, jvars, port, _, sd = case("taskprompter")
    port = copy.deepcopy(port)
    port.backbone.pos_embed = torch.nn.Parameter(torch.zeros(1, 21, 64))
    with pytest.raises(ValueError, match="square"):
        convert_full_checkpoint(sd, port)
    params = dict(jvars["params"])
    params["backbone"] = {**params["backbone"],
                          "pos_embed": np.zeros((1, 21, 64), np.float32)}
    with pytest.raises(ValueError, match="cannot resample"):
        J(sd, {**jvars, "params": params}, "TaskPrompter", list(TASKS),
          DEPTH, heads=HEADS)


def _cli_config(tmp_path, monkeypatch):
    """The PASCAL TaskPrompter experiment cut to the fixture's model: ViT-T
    at 64x64, semseg and edge."""
    from test_torch_inference import _yaml
    from mtt_tpu_torch.config.config import DB_SCALES
    monkeypatch.setitem(DB_SCALES, "PASCALContext", (IMG, IMG))
    return _yaml(tmp_path, ("pascal", "taskprompter_vitLp16.yml"), (
        ("backbone: TaskPrompter_vitL", "backbone: TaskPrompter_vitT"),
        ("embed_dim: 300", f"embed_dim: {TAR}"),
        ("final_embed_dim: 350", f"final_embed_dim: {FIN}"),
        ("include_human_parts: True", "include_human_parts: False"),
        ("include_sal: True", "include_sal: False"),
        ("include_normals: True", "include_normals: False")))


def test_cli_then_inference_matches_jax(tmp_path, monkeypatch, capsys,
                                       case):
    """A DDP-wrapped reference ``.pth.tar`` through ``python -m
    mtt_tpu_torch.convert_checkpoint`` (``main(argv, device="cpu")``) into
    the experiment's checkpoint directory, then the inference CLI from that
    checkpoint on a PNG: its logits against the JAX forward of JAX's
    converted variables on the CLI's input; each PNG equal to the one the
    JAX logits give, but where the JAX logits lie within the tolerance of
    the decision (semseg's two best classes) or of a level (edge's
    truncation to uint8). Then ``main --run_mode infer`` resumes from the
    same directory at step 0 and hands its eval pass JAX's converted
    variables, bit for bit."""
    import inference as root
    from test_torch_inference import _photo
    from mtt_tpu.utils.postprocess import get_output
    from mtt_tpu_torch import convert_checkpoint, inference
    from mtt_tpu_torch import main as port_main
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.evaluation.save_preds import read_png, write_png
    from mtt_tpu_torch.utils import train_utils
    jnet, jvars, _, _, sd = case("taskprompter")
    monkeypatch.chdir(tmp_path)
    yml = _cli_config(tmp_path, monkeypatch)
    ckpt = str(tmp_path / "model_best.pth.tar")
    torch.save({"model": {"module." + k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}, "epoch": 3}, ckpt)
    ck_dir = create_config(yml, {"run_mode": "infer"})["checkpoint"]
    assert convert_checkpoint.main(["--config_exp", yml, "--torch", ckpt,
                                    "--out", ck_dir], device="cpu") == 0
    assert sorted(os.listdir(ck_dir)) == ["latest.txt", "step_0.pt"]

    seen = {}
    real = inference.predict

    def spy(model, images, **kw):
        seen.update(model=model, x=images.numpy().copy())
        logits, preds = real(model, images, **kw)
        seen["logits"] = logits
        return logits, preds
    monkeypatch.setattr(inference, "predict", spy)
    write_png(str(tmp_path / "in.png"), _photo(48, 56, 4))
    out = tmp_path / "out"
    assert inference.main(["--config_exp", yml, "--image_path",
                           str(tmp_path / "in.png"), "--ckpt_dir", ck_dir,
                           "--output_dir", str(out), "--dtype", "float32"],
                          device="cpu") == 0

    variables = _jax_full("taskprompter", sd, jvars)
    # jitted: the eager forward's first call takes 10 s on the CPU
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, jnp.asarray(seen["x"]))
    slack = _gelu_poly_slack(seen["model"], seen["x"])
    for t in TASKS:
        w = np.asarray(want[t])
        g = seen["logits"][t].numpy()
        tol = 1e-5 * np.abs(w).max() + slack[t]
        assert g.shape == w.shape == (1, *IMG, TP_OUT[t])
        assert np.abs(g - w).max() <= tol, t
        png = read_png(str(out / f"{t}.png"))
        ref = root.visualize(t, np.asarray(get_output(jnp.asarray(w), t))[0])
        if t == "semseg":
            top2 = np.sort(w[0], -1)
            near = top2[..., -1] - top2[..., -2] <= 2 * tol
            assert np.array_equal(png[~near], ref[~near]), t
        else:
            assert np.abs(png.astype(int) - ref.astype(int)).max() <= 1, t

    # main's eval pass itself is tested in test_torch_loop.py: here only
    # the model it is handed, in place of scoring 64 images
    def test_phase(p, model, loader, **kw):
        seen["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        return {}
    monkeypatch.setattr(train_utils, "test_phase", test_phase)
    capsys.readouterr()
    assert port_main.main(["--config_exp", yml, "--run_mode", "infer",
                           "--dtype", "float32"], device="cpu") == 0
    assert "resumed from step 0" in capsys.readouterr().out
    _assert_bit_equal(seen["state"], _flax_sd(variables))


def test_cli_npz_fills_the_backbone(tmp_path, monkeypatch):
    """``--npz`` on the same experiment: the restored trainer's backbone is
    ``load_vit_npz_taskprompter``'s over the CLI's seeded model, and the
    decode and heads keep the seeded values."""
    from mtt_tpu_torch import convert_checkpoint
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.models.convert import load_vit_npz_taskprompter
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model
    from mtt_tpu_torch.utils.train_utils import Trainer
    yml = _cli_config(tmp_path, monkeypatch)
    path, _ = make_npz(tmp_path, depth=DEPTH, C=64, grid=6)
    ck_dir = str(tmp_path / "ck")
    assert convert_checkpoint.main(["--config_exp", yml, "--npz", path,
                                    "--out", ck_dir], device="cpu") == 0
    p = create_config(yml, {"run_mode": "infer"})

    def model(seed):
        gen = torch.Generator().manual_seed(seed)
        m = build_model(p, img_size=IMG, device="cpu", dtype=torch.float32)
        init_weights(m, gen)
        return m, gen
    seeded, _ = model(0)
    want = load_vit_npz_taskprompter(path, seeded.state_dict(), DEPTH,
                                     (4, 4), num_heads=HEADS)
    restored, gen = model(1)
    trainer = Trainer(restored, p, p.TASKS.NAMES, torch.float32, gen,
                      log_fn=lambda s: None)
    assert trainer.restore_checkpoint(ck_dir) == 0
    _assert_bit_equal(restored.state_dict(), want)


def test_reference_file_weights_only_unless_allowed(tmp_path):
    """A ``.pth.tar`` that pickles more than tensors (an argparse namespace
    beside the weights) is refused under ``weights_only=True`` and read with
    ``allow_pickle``; the ``{"model": ...}`` wrapper and the DDP
    ``module.`` prefix go."""
    import argparse
    from mtt_tpu_torch.convert_checkpoint import load_reference
    sd = {"module.backbone.norm.weight": torch.arange(3.0)}
    plain, pickled = str(tmp_path / "a.pth.tar"), str(tmp_path / "b.pth.tar")
    torch.save({"model": sd, "epoch": 3}, plain)
    torch.save({"model": sd, "args": argparse.Namespace(lr=1.0)}, pickled)
    for path, allow in ((plain, False), (pickled, True)):
        got = load_reference(path, allow_pickle=allow)
        assert list(got) == ["backbone.norm.weight"]
        assert torch.equal(got["backbone.norm.weight"], torch.arange(3.0))
    with pytest.raises(SystemExit, match="allow_pickle"):
        load_reference(pickled)
