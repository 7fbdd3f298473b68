"""The port's experiment configuration against the JAX package's, on the
CPU: its YAML reader against PyYAML's ``safe_load`` and its
``create_config`` against JAX's on every file in ``configs/`` (equal values
and types; the comparison is exact)."""

import glob
import os

import pytest
import yaml

CONFIGS = sorted(os.path.relpath(f, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))) for f in glob.glob(os.path.join(
        os.path.dirname(__file__), "..", "configs", "**", "*.yml"),
        recursive=True))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(got, want, where=""):
    """Equal values of equal types, through nested mappings and lists (the
    port's Config against JAX's, plain dicts against PyYAML's)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def test_there_are_six_configs():
    assert len(CONFIGS) == 6


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_equals_safe_load(path):
    from mtt_tpu_torch.config.config import load_yaml
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    _same(load_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("path", CONFIGS)
def test_create_config_equals_jax(path, tmp_path, monkeypatch):
    """Every key: the YAML's, ``TASKS`` (names, outputs, resize modes),
    ``edge_w``, the scales, the output paths (made under the working
    directory), the defaults, and Cityscapes-3D's ``det_cfg`` with its
    strides scaled by the dataset's and the model's downscale."""
    from mtt_tpu.config.config import create_config as jax_config
    from mtt_tpu_torch.config.config import create_config
    monkeypatch.chdir(tmp_path)
    want = jax_config(os.path.join(ROOT, path))
    got = create_config(os.path.join(ROOT, path))
    _same(got, want)
    assert os.path.isdir(got["save_dir"])
    if "3ddet" in want.TASKS.NAMES:
        assert got.det_cfg.strides == want.det_cfg.strides != \
            (8, 16, 32, 32, 64)


@pytest.mark.parametrize("text, what", [
    ("a:\n  - 1\n", "block sequences"),
    ("a: &x 1\n", "outside the subset"),
    ("a: !!str 1\n", "outside the subset"),
    ("a: 010\n", "outside the subset"),
    ("a: 1:30\n", "outside the subset"),
    ("a: [1, 2\n", "unterminated"),
    ("a: 1\n\tb: 2\n", "tab"),
    ("a: 1\na: 2\n", "duplicate"),
    ("a:\n    b: 1\n  c: 2\n", "indentation"),
    ('a: "x\\ty"\n', "escapes"),
    ("---\na: 1\n", "document markers"),
])
def test_yaml_reader_refuses_what_it_does_not_take(text, what):
    """Constructs outside the subset raise instead of reading otherwise
    than PyYAML would."""
    from mtt_tpu_torch.config.config import load_yaml
    with pytest.raises(ValueError, match=what):
        load_yaml(text)


def test_yaml_reader_scalars_as_safe_load():
    """Plain scalars resolved by YAML 1.1's rules, as PyYAML resolves
    them: ints, floats with and without exponent, bools, null, strings
    that only look like numbers, comments after values and in quotes."""
    from mtt_tpu_torch.config.config import load_yaml
    text = ("i: -12\nf: 2.e-5\ng: 1e-6\nh: .5\nt: True\nn: off\nz: ~\n"
            "e:\ns: 3ddet\nq: 'a # b'\nd: \"x: y\"  # c\n"
            "m: {'k': [1, 2.0, 'x'], j: no}\nl: [a, 'b', 1.5e+3]\n")
    _same(load_yaml(text), yaml.safe_load(text))
