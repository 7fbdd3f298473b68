"""The PyTorch port's TaskPrompter-ViT eval forward against the JAX package.

ViT-T (TaskPrompter_vitT), 5 PASCAL tasks, CTR on, chan_nheads 1, at 64x64.
The JAX weights are made with numpy from a seed over the shapes of the JAX
model's tree, carried into the port by ``state_dict_from_flax`` (strict
load), and both models run the same numpy image batch in f32 on the CPU.

Tolerance: max |port - jax| <= 1e-5 * max |jax| per task. The two sides run
the same function in f32 with sums in another order, the port's MLP GELU on
the A&S erf (|err| <= 1.5e-7) and its softmax in exp2 form. The port's
factored head runs the up4 head kernel's function, whose GELU at f32 is the
A&S erf of JAX's f32 head (the XLA composition JAX's factored head runs on
the CPU), so that case takes the same tolerance.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_threads import torch_threads  # noqa: F401

TASKS = ("semseg", "human_parts", "sal", "normals", "edge")
NUM_OUT = {"semseg": 21, "human_parts": 7, "sal": 2, "normals": 3, "edge": 1}
TAR, FIN = 24, 28
IMG = (64, 64)


def random_variables(model, x, seed):
    """The JAX model's variable tree filled from numpy: LeCun-scaled
    kernels, non-trivial biases, LN/BN scales and BN statistics. ``x`` is
    the model's input, or a tuple of its inputs."""
    args = x if isinstance(x, tuple) else (x,)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        n = rng.normal(size=s.shape)
        if name == "kernel":
            v = n * math.prod(s.shape[:-1]) ** -0.5
        elif name in ("scale", "var"):
            v = 1.0 + 0.1 * np.abs(n)
        elif name == "pos_embed":
            v = 0.02 * n
        elif name == "task_prompts":
            v = 1.0 + n
        else:                                   # bias, BN mean
            v = 0.1 * n
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_net(tasks=TASKS, num_out=NUM_OUT):
    from mtt_tpu.models.wrappers import TaskPrompterNet
    return TaskPrompterNet(tasks=tasks, num_outputs=num_out,
                           backbone_name="TaskPrompter_vitT", tar_dim=TAR,
                           final_dim=FIN, use_ctr=True, chan_nheads=1,
                           drop_path_rate=0.0)


def _port_net(tasks=TASKS, num_out=NUM_OUT, head_up4="factored"):
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet
    return TaskPrompterNet(tasks, num_out, IMG, "TaskPrompter_vitT",
                           tar_dim=TAR, final_dim=FIN, use_ctr=True,
                           chan_nheads=1, head_up4=head_up4, device="cpu")


def _compare(got, want, num_out, extra=None):
    for t, n in num_out.items():
        g = got[t].detach().numpy()
        w = np.asarray(want[t])
        assert g.shape == w.shape == (2, *IMG, n)
        err = np.abs(g - w).max()
        tol = 1e-5 * np.abs(w).max() + (extra or {}).get(t, 0.0)
        assert err <= tol, (t, err, tol)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).normal(size=(2, *IMG, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def variables(image):
    return random_variables(_jax_net(), jnp.asarray(image), seed=1)


def _load_port(variables, head_up4="factored"):
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    model = _port_net(head_up4=head_up4)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def port_model(variables):
    return _load_port(variables)


@pytest.fixture(scope="module")
def port_out(port_model, image):
    with torch.no_grad():
        return port_model(torch.from_numpy(image))


@pytest.mark.parametrize("head_impl", ["dense", "factored"])
def test_forward_matches_jax(head_impl, variables, image, port_model,
                             port_out, monkeypatch):
    """Each of the port's head modes against the same mode of the JAX
    package (MTT_HEAD_IMPL), on one parameter tree: the dense head within
    1e-5 of the output scale, the factored one too (module docstring)."""
    monkeypatch.setenv("MTT_HEAD_IMPL", head_impl)
    jnet = _jax_net()
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        variables, jnp.asarray(image))
    if head_impl == "factored":
        _compare(port_out, want, NUM_OUT)
        return
    with torch.no_grad():
        got = _load_port(variables, "dense")(torch.from_numpy(image))
    _compare(got, want, NUM_OUT)


def test_reference_checkpoint_loads_by_composition(image):
    """A reference-layout torch state dict -> convert_full_checkpoint ->
    state_dict_from_flax loads strictly and gives the JAX outputs."""
    from mtt_tpu.models.convert_torch import convert_full_checkpoint
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from test_convert_torch import (DEPTH, HEADS, NUM_OUT as REF_OUT,
                                    TASKS as REF_TASKS, make_taskprompter_sd)

    jnet = _jax_net(REF_TASKS, REF_OUT)
    x = jnp.asarray(image)
    sd = make_taskprompter_sd(np.random.default_rng(2))
    variables = convert_full_checkpoint(
        sd, dict(random_variables(jnet, x, seed=3)), "TaskPrompter",
        list(REF_TASKS), DEPTH, heads=HEADS, use_ctr=True)
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, x)

    # the dense head: the JAX factored head on the CPU runs the exact-GELU
    # composition, which the port's dense head computes
    model = _port_net(REF_TASKS, REF_OUT, head_up4="dense")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    # the reference's qkv rows reach the port head-major
    D = 64 // HEADS
    w = sd["backbone.blocks.0.attn.qkv.weight"]
    np.testing.assert_array_equal(
        model.backbone.blocks_0.qkv.weight.detach().numpy(),
        w.reshape(3, HEADS, D, 64).transpose(1, 0, 2, 3).reshape(192, 64))
    with torch.no_grad():
        got = model(torch.from_numpy(image))
    _compare(got, want, REF_OUT)


def test_predict_matches_jax_get_output(port_model, image, port_out):
    """predict = forward + get_output per task, against the JAX
    get_output on the same logits."""
    from mtt_tpu.utils.postprocess import get_output as jax_get_output
    from mtt_tpu_torch.inference import predict

    logits, preds = predict(port_model, torch.from_numpy(image))
    for t in TASKS:
        np.testing.assert_array_equal(logits[t].numpy(), port_out[t].numpy())
        want = np.asarray(jax_get_output(jnp.asarray(logits[t].numpy()), t))
        got = preds[t].numpy()
        assert got.shape == want.shape
        if t in ("semseg", "human_parts"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_build_model_from_config_dict():
    """build_model takes the keys of configs/pascal/taskprompter_vitLp16.yml
    as a plain dict; the tree matches the JAX model's."""
    from mtt_tpu_torch.models.wrappers import build_model
    p = {"model": "TaskPrompter", "backbone": "TaskPrompter_vitT",
         "head": "conv", "embed_dim": TAR, "final_embed_dim": FIN,
         "prompt_len": 1, "chan_nheads": 1, "use_ctr": True,
         "train_db_name": "PASCALContext", "val_db_name": "PASCALContext",
         "task_dictionary": {"include_semseg": True,
                             "include_human_parts": True, "include_sal": True,
                             "include_edge": True, "include_normals": True,
                             "edge_w": 0.95}}
    model = build_model(p, img_size=IMG, device="meta")
    assert model.tasks == ("semseg", "human_parts", "sal", "normals", "edge")
    assert model.head_semseg.linear_pred.out_channels == 21
    assert model.backbone.pos_embed.shape == (1, 17, 64)
