"""The port's data pipeline against the JAX package's, on the CPU: the
synthetic dataset's samples, the sampler, ``collate`` and the batch padding,
each transform against JAX's cv2 version on the same generator, and whole
loader epochs.

Tolerances: labels, crops, flips, pads and every uint8 image bit-equal; the
colour conversions bit-equal (the port computes cv2's integer and f32
arithmetic); the f32 image after a linear resize within 1e-4 (a few f32
ulps at 255; the port computes cv2's fused multiply-adds and matches it to
the bit on these inputs) and after a cubic resize within 1e-3 (cv2 sums the
four taps in an order the port does not repeat); loader batches: labels
bit-equal, the normalised images apart only where the uint8 cast of a resized
image flips by one level (1/255/std, at most 0.018), on at most 0.1% of the
pixels.
"""

import threading

import numpy as np
import pytest

from torch_threads import torch_threads  # noqa: F401

TASKS = ["semseg", "human_parts", "sal", "edge", "normals", "depth"]
NUM_OUT = {"semseg": 21, "human_parts": 7, "sal": 2, "edge": 1,
           "normals": 3, "depth": 1}


def _sample(size=(37, 53), idx=3):
    from mtt_tpu.data.synthetic import SyntheticMT
    s = SyntheticMT(TASKS, NUM_OUT, size=size)[idx]
    return {k: (np.asarray(v, np.float32)[..., None] if getattr(v, "ndim", 0)
                == 2 else v) for k, v in s.items()}


def _copy(s):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in s.items()}


def _equal_samples(got, want, image_atol=0.0):
    assert got.keys() == want.keys()
    for k in want:
        if not isinstance(want[k], np.ndarray):
            assert got[k] == want[k], k
        elif k == "image" and image_atol:
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=image_atol)
        else:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("idx", [0, 5])
def test_synthetic_dataset_matches_jax(idx):
    """``len``, ``ds[idx]`` with its ``meta`` and a transform's draws from
    the generator it is given, as the JAX dataset's."""
    from mtt_tpu.data.synthetic import SyntheticMT as JSynth
    from mtt_tpu.data.transforms import TrainTransforms as JT
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.data.transforms import TrainTransforms
    j = JSynth(TASKS, NUM_OUT, size=(40, 48), length=9,
               transform=JT((40, 48)))
    p = SyntheticMT(TASKS, NUM_OUT, (40, 48), length=9,
                    transform=TrainTransforms((40, 48)))
    assert len(p) == len(j) == 9
    _equal_samples(p.__getitem__(idx, rng=np.random.default_rng(4)),
                   j.__getitem__(idx, rng=np.random.default_rng(4)))
    _equal_samples(p[idx], j[idx])
    raw = SyntheticMT(TASKS, NUM_OUT, (40, 48))
    assert "meta" not in raw.batch(idx, 2)
    assert np.array_equal(raw.batch(idx, 2)["image"][0],
                          JSynth(TASKS, NUM_OUT, size=(40, 48))[idx]["image"])


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shards", [1, 2])
def test_sampler_matches_jax(drop_last, shards):
    """Every shard's batches over three epochs (a shuffled train order, the
    eval order with -1 pads), and the lengths."""
    from mtt_tpu.data.loader import ShardedSampler as J
    from mtt_tpu_torch.data.loader import ShardedSampler as P
    for shard in range(shards):
        j = J(23, 4, shuffle=drop_last, seed=3, num_shards=shards,
              shard_index=shard, drop_last=drop_last)
        p = P(23, 4, shuffle=drop_last, seed=3, num_shards=shards,
              shard_index=shard, drop_last=drop_last)
        assert len(p) == len(j)
        for epoch in range(3):
            j.set_epoch(epoch)
            p.set_epoch(epoch)
            assert list(p) == list(j)


def test_collate_and_pad_match_jax():
    """``collate`` (float32 stacks, ``meta`` and ``*idx`` as lists) and
    ``pad_batch_to_multiple`` (images repeated, labels ignore, det_* zero)
    equal JAX's."""
    from mtt_tpu.data import loader as J
    from mtt_tpu_torch.data import loader as P
    rng = np.random.default_rng(0)
    samples = [{"image": rng.random((4, 5, 3)), "semseg": rng.random((4, 5,
                                                                      1)),
                "det_valid": np.ones(3, np.float32), "sidx": i,
                "meta": {"img_name": f"s{i}"}} for i in range(3)]
    want, got = J.collate(samples), P.collate(samples)
    _equal_samples(got, want)
    for m in (1, 2, 4):
        _equal_samples(P.pad_batch_to_multiple(got, m),
                       J.pad_batch_to_multiple(want, m))


@pytest.mark.parametrize("scale", [0.53, 0.5, 1.0, 1.37, 1.99])
def test_resize_matches_cv2(scale):
    """Nearest, linear and cubic resizes of odd-sized arrays (2D and 3
    channels) up and down, as cv2.resize: nearest bit-equal, linear within
    1e-4, cubic within 1e-3."""
    import cv2
    from mtt_tpu_torch.data.transforms import resize
    rng = np.random.default_rng(int(scale * 100))
    for shape in ((37, 53, 3), (29, 41), (7, 5, 3)):
        a = (rng.random(shape) * 255).astype(np.float32)
        size = (max(1, int(shape[1] * scale)), max(1, int(shape[0] * scale)))
        for mode, flag, atol in (("nearest", cv2.INTER_NEAREST, 0.0),
                                 ("linear", cv2.INTER_LINEAR, 1e-4),
                                 ("cubic", cv2.INTER_CUBIC, 1e-3)):
            want = cv2.resize(a, size, interpolation=flag)
            got = resize(a, size, mode)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=(shape, mode))


@pytest.mark.parametrize("width", [61, 64, 97])
def test_hsv_round_trip_matches_cv2(width):
    """RGB -> HSV -> RGB of a seeded uint8 image with the 0 and 255 edges
    and the greys, and HSV -> RGB of every hue at a seeded saturation and
    value: bit-equal to cv2 (rows of ``width`` pixels: blocks of 32 and a
    tail)."""
    import cv2
    from mtt_tpu_torch.data.transforms import hsv2rgb, rgb2hsv
    rng = np.random.default_rng(width)
    img = rng.integers(0, 256, (41, width, 3)).astype(np.uint8)
    img[0], img[1] = 0, 255
    img[2] = np.arange(width)[:, None] * 255 // (width - 1)
    img[3, :, 0] = 255
    hsv = rgb2hsv(img)
    assert np.array_equal(hsv, cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    assert np.array_equal(hsv2rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    h = np.stack([np.arange(180) % 180] * 3, 0)[:, :width]
    grid = np.stack([h, rng.integers(0, 256, h.shape),
                     rng.integers(0, 256, h.shape)], -1).astype(np.uint8)
    grid[0, :, 1:] = 255
    assert np.array_equal(hsv2rgb(grid),
                          cv2.cvtColor(grid, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_each_transform_matches_jax(seed):
    """Each transform of the pipeline on the same sample and the same
    generator state as JAX's: random_scaling (labels bit-equal, the image
    within 1e-4), random_crop with the semseg rebalancing, random_hflip,
    photometric_distortion (uint8 images bit-equal), normalize_image,
    pad_image, add_ignore_regions and direct_resize; the generators end in
    the same state."""
    from mtt_tpu.data import transforms as J
    from mtt_tpu_torch.data import transforms as P
    base = _sample()
    base["image"] = np.round(base["image"])
    for name, args in (("random_scaling", ()),
                       ("random_crop", ((24, 30), 0.75)),
                       ("random_hflip", ()),
                       ("photometric_distortion", ()),
                       ("normalize_image", None), ("pad_image", ((48, 60),)),
                       ("add_ignore_regions", None),
                       ("direct_resize", ((23, 31),))):
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        s = _copy(base)
        if name in ("add_ignore_regions",):
            s["depth"][:3] = 0
            s["normals"][5:7] = 0
        if args is None:
            want, got = getattr(J, name)(_copy(s)), getattr(P, name)(_copy(s))
        elif name in ("pad_image", "direct_resize"):
            want = getattr(J, name)(_copy(s), *args)
            got = getattr(P, name)(_copy(s), *args)
        else:
            want = getattr(J, name)(_copy(s), rj, *args)
            got = getattr(P, name)(_copy(s), rp, *args)
        atol = {"random_scaling": 1e-4, "direct_resize": 1e-3}.get(name, 0)
        _equal_samples(got, want, image_atol=atol)
        assert rj.random() == rp.random(), name


def _loader_epochs(side, train, size=(40, 48), n=10, batch=3, workers=2):
    if side == "jax":
        from mtt_tpu.data.loader import MultiTaskLoader
        from mtt_tpu.data.synthetic import SyntheticMT
        from mtt_tpu.data.transforms import TrainTransforms, ValTransforms
    else:
        from mtt_tpu_torch.data.loader import MultiTaskLoader
        from mtt_tpu_torch.data.synthetic import SyntheticMT
        from mtt_tpu_torch.data.transforms import (TrainTransforms,
                                                   ValTransforms)
    tf = TrainTransforms(size, -1.0) if train else ValTransforms(size, -1.0)
    ds = SyntheticMT(TASKS, NUM_OUT, size, length=n, transform=tf)
    loader = MultiTaskLoader(ds, batch, shuffle=train, num_workers=workers,
                             seed=5, drop_last=train)
    out = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        out.extend(loader)
    return out


@pytest.mark.parametrize("train", [True, False])
def test_loader_epochs_match_jax(train):
    """Two epochs of ``MultiTaskLoader`` batches with ``TrainTransforms``
    (shuffled, random scale, crop, flip, jitter) or ``ValTransforms`` (in
    order, the last batch padded): every label and ``meta`` equal, the
    images apart by at most one uint8 level on at most 0.1% of pixels."""
    want, got = _loader_epochs("jax", train), _loader_epochs("port", train)
    assert len(got) == len(want) == (6 if train else 8)
    flips = total = 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["meta"] == w["meta"]
        for k in w:
            if k not in ("meta", "image"):
                assert np.array_equal(g[k], w[k]), k
        d = np.abs(g["image"] - w["image"])
        assert d.max() <= 1.0 / 255.0 / 0.224 + 1e-5
        flips += int((d > 0).sum())
        total += d.size
    assert flips <= 1e-3 * total, flips / total
    if not train:
        assert [m.get("pad", False) for m in got[3]["meta"]] == \
            [False, True, True]


def test_loader_raises_a_sample_error_in_the_consumer():
    """A sample whose loading raises re-raises in the consumer (the JAX
    loader's producer thread dies and its consumer waits forever): the
    consumer, run in a thread, ends within 10 s with the sample's error
    after the batches before it; and a consumer that stops early leaves no
    producer blocked."""
    from mtt_tpu_torch.data.loader import MultiTaskLoader

    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, idx, rng=None):
            if idx == 5:
                raise KeyError("sample 5 is broken")
            return {"image": np.zeros((2, 2, 3), np.float32)}

    loader = MultiTaskLoader(Broken(), 2, shuffle=False, num_workers=2,
                             drop_last=True, prefetch=1)
    seen, raised = [], []

    def consume():
        try:
            for b in loader:
                seen.append(b)
        except KeyError as exc:
            raised.append(exc)

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    th.join(10.0)
    assert not th.is_alive(), "the consumer waits forever"
    assert len(raised) == 1 and "sample 5" in str(raised[0])
    assert len(seen) == 2
    it = iter(MultiTaskLoader(Broken(), 1, shuffle=False, num_workers=1,
                              prefetch=1))
    assert next(it)["image"].shape == (1, 2, 2, 3)
    it.close()
