"""The model options of the port against the JAX package, on the CPU in f32:
every head of ``HEADS`` on every wrapper, the phase up4 head, and ``remat``.

- TaskPrompter-Swin with the ``conv`` head is JAX's dense ConvHead on the
  fused feature map (the tiny Swin of tests/test_torch_swin_model.py at
  depths (2, 2, 2, 2), semseg and depth).
- The head pairs that no shipped config uses: InvPT on ViT-T (embed_dim 32,
  PRED_OUT 8) with the ``conv`` and ``deconv`` heads, TaskPrompter-ViT-T
  with ``mlp``, ``deconv`` and the ``conv`` head in its ``phase`` mode (the
  JAX side under MTT_HEAD_IMPL=phase), each eval forward against the JAX
  wrapper on one numpy-seeded tree loaded strictly (``state_dict_from_flax``),
  within 1e-5 of each output's largest value (the same f32 function with sums
  in another order).
- ``ConvHead(up4="phase")`` alone against JAX's in eval and in training
  (batch statistics): outputs, running statistics, and the gradients of a
  scalar loss for every parameter and the input, within 1e-4 of each
  tensor's largest value; a gradient also within 1e-4 of the largest
  gradient of all, as the conv bias ahead of the batch-statistics BN has an
  exact gradient of zero, of which both sides give rounding noise.
- ``remat``: a rematted ``Trainer.backward`` of InvPT-ViT-T and of the tiny
  Swin with the FCOS3D loss (``tests/torch_dist_worker.py``'s models and
  batches, drop-path on) gives the plain step's losses, gradients, BN
  running statistics and drop-path generator state to the bit, while every
  rematted module ran twice; a JAX ``remat=True`` tree loads strictly into
  the port; ``build_model`` reads the key, and raises for TaskPrompter-ViT,
  whose JAX model has none.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_worker as W
from test_torch_detection import tiny_det_cfg
from test_torch_model import random_variables
from test_torch_swin_model import TINY, _fill
from torch_threads import torch_threads  # noqa: F401

PASCAL = ("semseg", "normals")
PASCAL_OUT = {"semseg": 21, "normals": 3}
TAR, FIN = 24, 28                   # tests/test_torch_model.py's ViT-T widths
EMBED, PRED = 32, 8                 # tests/test_torch_invpt_model.py's
IMG = (64, 64)
SWIN = dict(TINY, depths=(2, 2, 2, 2))
SWIN_IMG = (64, 128)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, rel=1e-5, what="", scale=0.0):
    """max |got - want| <= rel * max(max |want|, scale)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    tol = rel * max(np.abs(want).max(), scale)
    assert err <= tol, (what, err, tol)


def _tensor(a):
    return torch.from_numpy(np.array(a))


def _load(port, variables):
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return port.eval()


def test_swin_conv_head_is_jax_dense_conv_head():
    """``TaskPrompterSwinNet(head_name="conv")`` builds the dense ConvHead
    and computes conv3x3 on the fused feature map, as JAX's wrapper does
    (which calls ``ConvHead`` without ``up4``)."""
    from mtt_tpu.models.wrappers import TaskPrompterSwinNet as JNet
    from mtt_tpu_torch.models.wrappers import TaskPrompterSwinNet
    tasks, num_out = ("semseg", "depth"), {"semseg": 5, "depth": 1}
    x = _rand(0, 2, *SWIN_IMG, 3)
    jm = JNet(tasks=tasks, num_outputs=num_out, head_name="conv", **SWIN)
    v = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x))), 3)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = _load(TaskPrompterSwinNet(tasks, num_out, SWIN_IMG,
                                     head_name="conv", device="cpu", **SWIN),
                 v)
    assert port.head_semseg.up4 == "dense"
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for t in tasks:
        _close(got[t], want[t], what=t)


def _pair_nets(wrapper, head):
    """The JAX and the port model of one (wrapper, head) pair; ``phase`` is
    the conv head in its phase mode."""
    from mtt_tpu.models import wrappers as jw
    from mtt_tpu_torch.models import wrappers as tw
    name = "conv" if head == "phase" else head
    if wrapper == "invpt":
        kw = dict(embed_dim=EMBED, pred_out=PRED, drop_path_rate=0.0)
        return (jw.TransformerNet(tasks=PASCAL, num_outputs=PASCAL_OUT,
                                  backbone_name="vitT", head_name=name, **kw),
                tw.TransformerNet(PASCAL, PASCAL_OUT, IMG, "vitT",
                                  head_name=name, device="cpu", **kw))
    kw = dict(tar_dim=TAR, final_dim=FIN, use_ctr=True, chan_nheads=1,
              drop_path_rate=0.0)
    return (jw.TaskPrompterNet(tasks=PASCAL, num_outputs=PASCAL_OUT,
                               backbone_name="TaskPrompter_vitT",
                               head_name=name, **kw),
            tw.TaskPrompterNet(PASCAL, PASCAL_OUT, IMG, "TaskPrompter_vitT",
                               head_name=name, device="cpu",
                               head_up4="phase" if head == "phase" else None,
                               **kw))


@pytest.mark.parametrize("wrapper,head", [
    ("invpt", "conv"), ("invpt", "deconv"), ("taskprompter", "mlp"),
    ("taskprompter", "deconv"), ("taskprompter", "phase")])
def test_head_pair_eval_forward_matches_jax(wrapper, head, monkeypatch):
    for k in ("MTT_HEAD_IMPL", "MTT_HEAD_UP4", "MTT_TAIL_HEAD"):
        monkeypatch.delenv(k, raising=False)
    if head == "phase":
        monkeypatch.setenv("MTT_HEAD_IMPL", "phase")
    jm, port = _pair_nets(wrapper, head)
    x = _rand(1, 2, *IMG, 3)
    v = random_variables(jm, jnp.asarray(x), seed=4)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    _load(port, v)
    if wrapper == "taskprompter":
        # only a fused conv head takes the patch grid
        assert port.backbone.upsample_out == (head != "phase")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for t in PASCAL:
        _close(got[t], want[t], what=t)
        if wrapper == "invpt":
            _close(got["inter_preds"][t], want["inter_preds"][t],
                   what=f"inter_preds.{t}")


PHASE_X = (2, 5, 7, 12)             # a non-square patch grid, C = 12
PHASE_N = 3


@pytest.fixture(scope="module")
def phase_case():
    """JAX's phase ConvHead: seeded variables, input and loss weights; its
    eval output, and its training output, new batch statistics and the
    gradients of sum(y * w) for the parameters and the input."""
    from mtt_tpu.models.heads import ConvHead
    head = ConvHead(PHASE_N, up4="phase")
    x = jnp.asarray(_rand(2, *PHASE_X))
    v = random_variables(head, x, seed=5)
    B, gh, gw, _ = PHASE_X
    w = jnp.asarray(_rand(3, B, 4 * gh, 4 * gw, PHASE_N))

    def loss(params, x):
        y, new = head.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, x, train=True,
                            mutable=["batch_stats"])
        return (y * w).sum(), (y, new["batch_stats"])

    (_, (y, stats)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], x)
    return dict(v=v, x=x, w=w, eval=head.apply(v, x, train=False),
                train=y, stats=stats, grads=grads)


def _phase_port(v):
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.models.heads import ConvHead
    head = ConvHead(PHASE_X[-1], PHASE_N, up4="phase", device="cpu")
    head.load_state_dict(state_dict_from_flax(v), strict=True)
    return head


def test_phase_head_eval_matches_jax(phase_case):
    """Eval: BN and the conv bias folded, the per-phase 1x1, the border
    strips through the same epilogue scattered into the logits; equal to the
    dense head on the 4x upsampled input."""
    from mtt_tpu_torch.models.heads import ConvHead
    from mtt_tpu_torch.models.layers import interpolate
    head = _phase_port(phase_case["v"])
    x = _tensor(phase_case["x"])
    with torch.no_grad():
        got = head(x)
        dense = ConvHead(PHASE_X[-1], PHASE_N, up4="dense", device="cpu")
        dense.load_state_dict(head.state_dict())
        B, gh, gw, _ = PHASE_X
        composite = dense(interpolate(x, (4 * gh, 4 * gw)))
    _close(got, phase_case["eval"], rel=1e-4)
    _close(got, composite.numpy(), rel=1e-4, what="dense composite")


@pytest.mark.parametrize("part", ["output", "stats", "grads"])
def test_phase_head_training_matches_jax(phase_case, part):
    """Training: the borders fixed before the batch moments (through
    ``batch_moments``), the running averages, and the backward."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    head = _phase_port(phase_case["v"])
    x = _tensor(phase_case["x"]).requires_grad_()
    y = head(x, train=True)
    (y * _tensor(phase_case["w"])).sum().backward()
    if part == "output":
        _close(y, phase_case["train"], rel=1e-4)
    elif part == "stats":
        want = state_dict_from_flax({"params": {},
                                     "batch_stats": phase_case["stats"]})
        running = {k: v for k, v in head.state_dict().items()
                   if "running" in k}
        assert running.keys() == {k for k in want if "running" in k}
        for k, got in running.items():
            _close(got, want[k].numpy(), rel=1e-4, what=k)
    else:
        gp, gx = phase_case["grads"]
        want = state_dict_from_flax({"params": gp})
        top = max(g.abs().max().item() for g in want.values())
        for name, p in head.named_parameters():
            _close(p.grad, want[name].numpy(), rel=1e-4, what=name,
                   scale=top)
        _close(x.grad, gx, rel=1e-4, what="input")


def _rematted(model, kind):
    """The modules that ``remat`` checkpoints in ``model``."""
    if kind == "invpt":
        return [model.backbone.get_submodule(f"blocks_{i}")
                for i in range(model.backbone.depth)]
    bb = model.backbone
    return [m for n, m in bb.named_children() if "_block" in n] + \
        [model.head_semseg, model.head_depth, model.det_head]


def _step(kind, remat):
    """One f32 ``Trainer.backward`` of ``W.build(kind)`` on the whole global
    batch with drop-path on: losses, gradients, buffers, the generator's
    state after the step, and the forward calls of each rematted module."""
    from mtt_tpu_torch.utils.train_utils import Trainer
    model = W.build(kind, remat=remat)
    calls = []
    for m in _rematted(model, kind):
        calls.append(0)
        i = len(calls) - 1
        m.register_forward_hook(
            lambda *a, i=i: calls.__setitem__(i, calls[i] + 1))
    gen = torch.Generator().manual_seed(5)
    trainer = Trainer(model, W.config(kind), W.KINDS[kind][0], torch.float32,
                      gen, log_fn=lambda s: None)
    losses = trainer.backward(W.global_batch(kind))
    return dict(losses=losses, calls=calls, gen=gen.get_state(),
                grads={n: w.grad for n, w in model.named_parameters()},
                buffers={n: b.clone() for n, b in model.named_buffers()},
                weights=dict(model.named_parameters()))


@pytest.mark.parametrize("kind", ["invpt", "swin"])
def test_remat_step_equals_plain_step_bits(kind):
    """The rematted step recomputes every checkpointed module in the backward
    (each ran twice) and gives the plain step's bits: the recompute redraws
    the drop-path masks from the generator's state at the first run and
    leaves it where the forward left it, and updates no BN statistic."""
    plain, remat = _step(kind, False), _step(kind, True)
    for n, w in plain["weights"].items():
        assert torch.equal(w, remat["weights"][n]), n
    assert plain["calls"] == [1] * len(plain["calls"])
    assert remat["calls"] == [2] * len(plain["calls"])
    assert plain["losses"].keys() == remat["losses"].keys()
    for k, v in plain["losses"].items():
        assert torch.equal(v, remat["losses"][k]), k
    for n, g in plain["grads"].items():
        assert (g is None) == (remat["grads"][n] is None), n
        assert g is None or torch.equal(g, remat["grads"][n]), n
    assert any("running_mean" in n for n in plain["buffers"])
    for n, b in plain["buffers"].items():
        assert torch.equal(b, remat["buffers"][n]), n
    assert torch.equal(plain["gen"], remat["gen"])


@pytest.mark.parametrize("kind", ["invpt", "swin"])
def test_jax_remat_tree_loads_strictly(kind):
    """JAX's ``nn.remat`` keeps the module names, so a ``remat=True`` tree is
    the plain one and loads strictly into a rematted port model."""
    from mtt_tpu.detection.det_params import default_det_params as jmake
    from mtt_tpu.models import wrappers as jw
    tasks, out, img, labels, _ = W.KINDS[kind]
    if kind == "invpt":
        jm = jw.TransformerNet(tasks=tasks, num_outputs=out,
                               backbone_name="vitT", embed_dim=32,
                               pred_out=16, remat=True)
    else:
        jm = jw.TaskPrompterSwinNet(tasks=tasks, num_outputs=out,
                                    det_cfg=tiny_det_cfg(jmake, 6),
                                    target_size=labels, remat=True, **W.SWIN)
    x = jnp.zeros((1, *img, 3))
    v = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x)), 0)
    port = W.build(kind, remat=True)
    assert port.backbone.remat
    _load(port, v)


def _p(model):
    from mtt_tpu_torch.models.wrappers import (CS3D_SWINB, INVPT_PASCAL_VITL,
                                               PASCAL_TASKPROMPTER_VITB)
    return {"invpt": dict(INVPT_PASCAL_VITL, backbone="vitT"),
            "taskprompter": dict(PASCAL_TASKPROMPTER_VITB,
                                 backbone="TaskPrompter_vitT"),
            "swin": CS3D_SWINB}[model]


@pytest.mark.parametrize("model", ["invpt", "taskprompter", "swin"])
@pytest.mark.parametrize("head", ["mlp", "conv", "deconv"])
def test_build_model_builds_every_head(model, head):
    """Every wrapper with every head of ``HEADS``, at its config's widths on
    the meta device: a conv head is dense unless TaskPrompter-ViT fuses the
    upsample into it (factored by default)."""
    from mtt_tpu_torch.models.heads import HEADS
    from mtt_tpu_torch.models.wrappers import build_model
    net = build_model(dict(_p(model), head=head),
                      img_size=None if model == "swin" else IMG,
                      device="meta")
    assert type(net.head_semseg) is HEADS[head]
    if head == "conv":
        want = "factored" if model == "taskprompter" else "dense"
        assert net.head_semseg.up4 == want
    if model == "taskprompter":
        assert net.backbone.upsample_out == (head != "conv")


def test_build_model_reads_remat_and_head_up4():
    """``remat`` from the config dict reaches InvPT's ViT and
    TaskPrompter-Swin; a TaskPrompter-ViT config that sets it raises (JAX's
    model has no remat), as does ``head_up4`` for a model without the fused
    conv head. ``head_up4`` reaches TaskPrompter-ViT's conv heads."""
    from mtt_tpu_torch.models.wrappers import build_model
    for model in ("invpt", "swin"):
        p = _p(model)
        kw = dict(img_size=None if model == "swin" else IMG, device="meta")
        assert not build_model(p, **kw).backbone.remat
        net = build_model(dict(p, remat=True), **kw)
        assert net.backbone.remat
        if model == "swin":
            assert net.remat
        with pytest.raises(ValueError, match="head_up4"):
            build_model(p, head_up4="phase", **kw)
    p = _p("taskprompter")
    with pytest.raises(ValueError, match="remat"):
        build_model(dict(p, remat=True), img_size=IMG, device="meta")
    assert build_model(dict(p, remat=False), img_size=IMG,
                       device="meta").head_semseg.up4 == "factored"
    for mode in ("phase", "dense"):
        net = build_model(p, img_size=IMG, head_up4=mode, device="meta")
        assert net.head_semseg.up4 == mode
        assert net.backbone.upsample_out == (mode == "dense")
    with pytest.raises(ValueError, match="head_up4"):
        build_model(dict(p, head="mlp"), img_size=IMG, head_up4="phase",
                    device="meta")
