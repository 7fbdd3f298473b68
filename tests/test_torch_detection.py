"""The port's detection modules and box decoding against the JAX package, on
the CPU, in f32.

The JAX weights are made with numpy from a seed over the shapes of the JAX
module's tree and carried into the port by ``state_dict_from_flax`` (strict
load); both sides run the same numpy inputs.

Tolerance, unless a test says otherwise: max |port - jax| <= 1e-5 * max |jax|
per output (the same function in f32 with sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _load(port, variables):
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return port.eval()


def _close(got, want, rel=1e-5, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def tiny_det_cfg(make, num_classes=3):
    """The JAX test suite's tiny detection head (tests/test_swin.py), on
    either package's ``default_det_params``."""
    d = make(num_classes)
    d["feat_channels"] = 16
    d["cls_branch"] = (16, 8)
    d["reg_branch"] = ((16,),) * 5
    d["dir_branch"] = (16,)
    d["centerness_branch"] = (16,)
    d["norm_groups"] = 4
    d["neck"]["out_channels"] = 16
    return d


def test_det_params_match_jax():
    from mtt_tpu.detection.det_params import default_det_params as jmake
    from mtt_tpu_torch.detection.det_params import default_det_params

    def plain(v):
        if hasattr(v, "items"):
            return {k: plain(x) for k, x in v.items()}
        return tuple(plain(x) for x in v) if isinstance(v, (tuple, list)) \
            else v

    want = plain(jmake(6))
    got = default_det_params(6)
    for k, v in got.items():
        assert plain(v) == want[k], k
    # the losses' settings and max_boxes included, nothing is left out
    assert set(want) == set(got)


def test_bilinear_gather_matches_jax():
    """Fractional positions inside, on the border and outside the map."""
    from mtt_tpu.ops.deform_conv import bilinear_gather as jgather
    from mtt_tpu_torch.ops.deform_conv import bilinear_gather
    x = _rand(0, 2, 5, 7, 3)
    rng = np.random.default_rng(1)
    py = rng.uniform(-1.5, 6.5, size=(2, 4, 6)).astype(np.float32)
    px = rng.uniform(-1.5, 8.5, size=(2, 4, 6)).astype(np.float32)
    want = jgather(jnp.asarray(x), jnp.asarray(py), jnp.asarray(px))
    _close(bilinear_gather(_t(x), _t(py), _t(px)), want)
    # integer positions return the pixels themselves
    yy, xx = np.meshgrid(np.arange(5.0), np.arange(7.0), indexing="ij")
    pos = [np.broadcast_to(a, (2, 5, 7)).astype(np.float32) for a in (yy, xx)]
    assert torch.equal(bilinear_gather(_t(x), _t(pos[0]), _t(pos[1])), _t(x))


def test_deform_conv_matches_jax():
    """Non-zero offsets and masks (random ``offset_mask`` weights), tap-major
    weight columns and the (y, x) offset order."""
    from mtt_tpu.ops.deform_conv import DeformConv2d as JDcn
    from mtt_tpu_torch.ops.deform_conv import DeformConv2d
    x = _rand(0, 2, 6, 9, 8)
    jm = JDcn(12)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    want = jm.apply(v, jnp.asarray(x))
    om = np.asarray(v["params"]["offset_mask"]["kernel"])
    assert np.abs(om).max() > 0.1          # the deformation is real
    port = _load(DeformConv2d(8, 12), v)
    _close(port(_t(x)), want)


@pytest.mark.parametrize("sizes", [((8, 16), (4, 8), (2, 4), (2, 4)),
                                   ((6, 10), (3, 5), (3, 5))])
def test_fpn_matches_jax(sizes):
    """Top-down nearest resize (2x and identity), and the stride-2 extra
    convs with XLA's SAME padding on even and odd sizes."""
    from mtt_tpu.detection.fpn import FPN as JFPN
    from mtt_tpu_torch.detection.fpn import FPN
    xs = [_rand(i, 2, h, w, 10) for i, (h, w) in enumerate(sizes)]
    jm = JFPN(out_channels=8, num_outs=len(sizes) + 2)
    v = random_variables(jm, [jnp.asarray(x) for x in xs], seed=1)
    want = jm.apply(v, [jnp.asarray(x) for x in xs])
    port = _load(FPN((10,) * len(sizes), 8, len(sizes) + 2), v)
    got = port([_t(x) for x in xs])
    assert len(got) == len(want) == len(sizes) + 2
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"level {i}")


def _head_outputs_close(got, want):
    for name, gl, wl in zip(("cls", "bbox", "dir", "ctr"), got, want):
        assert len(gl) == len(wl)
        for i, (g, w) in enumerate(zip(gl, wl)):
            _close(g, w, what=f"{name} level {i}")


def test_fcos3d_head_matches_jax():
    """Shared towers with DCN on the last conv, GroupNorm (eps 1e-6), the
    per-level scales and the exp / relu activations."""
    from mtt_tpu.detection.fcos3d_head import FCOS3DHead as JHead
    from mtt_tpu_torch.detection.fcos3d_head import FCOS3DHead
    kw = dict(num_classes=3, feat_channels=16, stacked_convs=2,
              cls_branch=(16, 8), reg_branch=((16,),) * 5, dir_branch=(16,),
              centerness_branch=(16,), num_levels=3, norm_groups=4)
    xs = [0.3 * _rand(i, 1, h, w, 16) for i, (h, w) in
          enumerate([(6, 8), (3, 4), (2, 2)])]
    jm = JHead(**kw)
    v = random_variables(jm, [jnp.asarray(x) for x in xs], seed=1)
    want = jm.apply(v, [jnp.asarray(x) for x in xs])
    port = _load(FCOS3DHead(in_channels=16, **kw), v)
    assert port.cls_tower_1.use_dcn and not port.cls_tower_0.use_dcn
    _head_outputs_close(port([_t(x) for x in xs]), want)


def test_detection_head_matches_jax():
    from mtt_tpu.detection.det_params import default_det_params as jmake
    from mtt_tpu.detection.fcos3d_head import DetectionHead as JDet
    from mtt_tpu_torch.detection.det_params import default_det_params
    from mtt_tpu_torch.detection.fcos3d_head import DetectionHead
    xs = [0.3 * _rand(i, 1, h, w, 20) for i, (h, w) in
          enumerate([(8, 16), (4, 8), (2, 4), (2, 4)])]
    jm = JDet(det_cfg=tiny_det_cfg(jmake))
    v = random_variables(jm, [jnp.asarray(x) for x in xs], seed=1)
    want = jm.apply(v, [jnp.asarray(x) for x in xs])
    port = _load(DetectionHead(tiny_det_cfg(default_det_params), (20,) * 4),
                 v)
    got = port([_t(x) for x in xs])
    assert [tuple(c.shape[1:3]) for c in got[0]] == [
        (8, 16), (4, 8), (2, 4), (2, 4), (1, 2)]
    _head_outputs_close(got, want)


def _bev_boxes(seed, n):
    """BEV boxes far from the origin that overlap in clusters, some of them
    identical or axis-parallel (the degenerate cases of the clipping)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-3, 3, size=(n, 2)) + np.array([40.0, 60.0])
    boxes = np.concatenate([centres, rng.uniform(1.0, 4.0, size=(n, 2)),
                            rng.uniform(-np.pi, np.pi, size=(n, 1))], 1)
    boxes[1] = boxes[0]                              # identical
    boxes[2, 4] = boxes[3, 4] = 0.0                  # parallel edges
    boxes[4, :2] += 500.0                            # disjoint from all
    return boxes.astype(np.float32)


def test_box_geometry_matches_jax():
    from mtt_tpu.detection import box3d as jb
    from mtt_tpu_torch.detection import box3d as tb
    v = _rand(0, 50) * 7
    _close(tb.limit_period(_t(v), 0, np.pi), jb.limit_period(
        jnp.asarray(v), 0, np.pi), rel=1e-6)
    _close(tb.limit_period(_t(v)), jb.limit_period(jnp.asarray(v)), rel=1e-6)
    boxes = _rand(1, 9, 9)
    assert np.array_equal(tb.bbox_bev(_t(boxes)).numpy(),
                          np.asarray(jb.bbox_bev(jnp.asarray(boxes))))
    bev = _bev_boxes(2, 9)
    _close(tb.xywhr_to_corners(_t(bev)), jb.xywhr_to_corners(
        jnp.asarray(bev)), rel=1e-6)
    pts, dist = _rand(3, 9, 2), np.abs(_rand(4, 9, 4))
    _close(tb.distance2bbox(_t(pts), _t(dist)), jb.distance2bbox(
        jnp.asarray(pts), jnp.asarray(dist)), rel=1e-6)
    K = np.array([[2262.52, 0, 1096.98], [0, 2265.30, 513.137], [0, 0, 1]],
                 np.float32)
    uvd = np.abs(_rand(5, 9, 3)) * np.array([1000, 500, 30], np.float32)
    _close(tb.points_img2cam(_t(uvd), _t(K)), jb.points_img2cam(
        jnp.asarray(uvd), jnp.asarray(K)))


def test_boxes_iou_matches_jax():
    """Rotated and axis-aligned BEV IoU: 1e-5 of the largest IoU (1)."""
    from mtt_tpu.detection import iou3d as ji
    from mtt_tpu_torch.detection import iou3d as ti
    a, b = _bev_boxes(0, 24), _bev_boxes(1, 17)
    want = np.asarray(ji.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got = ti.boxes_iou_bev(_t(a), _t(b))
    assert np.abs(got.numpy() - want).max() <= 1e-5
    self_iou = ti.boxes_iou_bev(_t(a), _t(a)).numpy()
    assert abs(self_iou[0, 1] - 1.0) <= 1e-5 and self_iou[4, :4].max() == 0
    assert (want > 0.05).sum() > 20             # the clusters do overlap
    _close(ti.boxes_iou_aligned(_t(a)), ji.boxes_iou_aligned(jnp.asarray(a)))


def test_boxes_overlap_in_chunks(monkeypatch):
    """The pair grid is walked in chunks; the chunk size changes nothing."""
    from mtt_tpu_torch.detection import iou3d as ti
    a, b = _t(_bev_boxes(0, 12)), _t(_bev_boxes(1, 7))
    whole = ti.boxes_overlap_bev(a, b)
    monkeypatch.setattr(ti, "PAIR_CHUNK", 10)
    assert torch.equal(ti.boxes_overlap_bev(a, b), whole)


def test_greedy_nms_matches_jax():
    """The same keep mask as JAX's fixed-trip sweep, one class at a time and
    all classes in one sweep."""
    from mtt_tpu.detection import iou3d as ji
    from mtt_tpu_torch.detection import iou3d as ti
    boxes = _bev_boxes(0, 40)
    rng = np.random.default_rng(1)
    scores = rng.uniform(size=(3, 40)).astype(np.float32)
    scores[:, 7] = scores[:, 9]                      # a tie
    valid = scores > 0.2
    iou = ti.boxes_iou_bev(_t(boxes), _t(boxes))
    want = np.stack([np.asarray(ji._greedy_nms_from_iou(
        jnp.asarray(iou.numpy()), jnp.asarray(scores[c]), 0.3,
        jnp.asarray(valid[c]))) for c in range(3)])
    got = ti._greedy_nms_from_iou(iou, _t(scores), 0.3, _t(valid))
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()              # some were suppressed
    one = ti._greedy_nms_from_iou(iou, _t(scores[1]), 0.3, _t(valid[1]))
    assert np.array_equal(one.numpy(), want[1])


def _seeded_head_outputs(seed, sizes, nc, cls_bias):
    """One image's head outputs per level (cls, bbox, dir, ctr), with the
    class logits raised by ``cls_bias`` so that boxes survive ``score_thr``,
    positive depths and sizes, and offsets that cluster the centres."""
    rng = np.random.default_rng(seed)
    cls, bbox, dirp, ctr = [], [], [], []
    for h, w in sizes:
        cls.append(rng.normal(size=(h, w, nc)).astype(np.float32) + cls_bias)
        b = rng.normal(size=(h, w, 13)).astype(np.float32)
        b[..., 2] = np.exp(0.3 * b[..., 2]) * 20        # depth (m)
        b[..., 3:6] = np.exp(0.2 * b[..., 3:6]) * 2     # size
        b[..., 9:] = np.abs(b[..., 9:])
        bbox.append(b)
        dirp.append(rng.normal(size=(h, w, 6)).astype(np.float32))
        ctr.append(rng.normal(size=(h, w, 1)).astype(np.float32))
    return cls, bbox, dirp, ctr


@pytest.mark.parametrize("use_rotate_nms,scale_factor,cls_bias",
                         [(True, 1.0, -2.0), (False, (0.5, 0.75), -3.0)])
def test_decode_bboxes_matches_jax(use_rotate_nms, scale_factor, cls_bias):
    """The whole decode on seeded head outputs: the same keep mask, labels
    and order, boxes and scores at 1e-4 of their scale."""
    from mtt_tpu.detection.det_model import decode_bboxes_single as jdecode
    from mtt_tpu.detection.det_params import default_det_params as jmake
    from mtt_tpu_torch.detection.det_model import decode_bboxes_single
    from mtt_tpu_torch.detection.det_params import default_det_params
    sizes = [(12, 24), (6, 12), (3, 6), (3, 6), (2, 3)]
    head = _seeded_head_outputs(0, sizes, 3, cls_bias=cls_bias)
    K = np.array([[2262.52, 0, 1096.98], [0, 2265.30, 513.137], [0, 0, 1]],
                 np.float32)
    cfgs = []
    for make in (jmake, default_det_params):
        cfg = make(3)
        cfg["test_cfg"]["nms_pre"] = 150
        cfg["test_cfg"]["max_per_img"] = 120
        cfg["test_cfg"]["use_rotate_nms"] = use_rotate_nms
        cfgs.append(cfg)
    sf = scale_factor if isinstance(scale_factor, float) \
        else np.asarray(scale_factor, np.float32)
    want = jdecode(tuple([jnp.asarray(a) for a in lvl] for lvl in head),
                   jnp.asarray(K), cfgs[0], cfgs[0]["strides"], sf)
    got = decode_bboxes_single(tuple([_t(a) for a in lvl] for lvl in head),
                               _t(K), cfgs[1], cfgs[1]["strides"], sf)
    valid = np.asarray(want["valid"])
    assert 5 < valid.sum() < 120, valid.sum()    # boxes survive, some do not
    assert np.array_equal(got["valid"].numpy(), valid)
    assert np.array_equal(got["labels"].numpy()[valid],
                          np.asarray(want["labels"])[valid])
    for key in ("boxes3d", "bboxes2d", "scores", "centers2d"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        err = np.abs(g[valid] - w[valid]).max()
        assert err <= 1e-4 * np.abs(w[valid]).max(), (key, err)
    assert got["boxes3d"].shape == (120, 9) and got["scores"].shape == (120,)


def test_decode_3ddet_per_image_camera_and_scale():
    """``decode_3ddet`` on a batch of two images with their own camera
    matrices and a (x, y) ``scale_factor``: image i equals JAX's
    ``decode_bboxes_single`` with its own K (as the JAX evaluation decodes
    each image with its ``K_matrix``), and ``predict``'s arguments reach it."""
    from mtt_tpu.detection.det_model import decode_bboxes_single as jdecode
    from mtt_tpu.detection.det_params import default_det_params as jmake
    from mtt_tpu_torch.detection.det_params import default_det_params
    from mtt_tpu_torch.inference import decode_3ddet
    sizes = [(12, 24), (6, 12), (3, 6), (3, 6), (2, 3)]
    heads = [_seeded_head_outputs(s, sizes, 3, cls_bias=-2.0) for s in (0, 1)]
    Ks = np.array([[[2262.52, 0, 1096.98], [0, 2265.30, 513.137], [0, 0, 1]],
                   [[1500.0, 0, 700.0], [0, 1480.0, 380.0], [0, 0, 1]]],
                  np.float32)
    sf = np.asarray((0.5, 0.75), np.float32)
    cfgs = []
    for make in (jmake, default_det_params):
        cfg = make(3)
        cfg["test_cfg"]["nms_pre"] = 150
        cfg["test_cfg"]["max_per_img"] = 120
        cfgs.append(cfg)
    batched = tuple([torch.stack([_t(heads[0][g][lvl]), _t(heads[1][g][lvl])])
                     for lvl in range(len(sizes))] for g in range(4))
    got = decode_3ddet(batched, _t(Ks), cfgs[1], sf)
    for i in range(2):
        want = jdecode(tuple([jnp.asarray(a) for a in lvl]
                             for lvl in heads[i]),
                       jnp.asarray(Ks[i]), cfgs[0], cfgs[0]["strides"], sf)
        valid = np.asarray(want["valid"])
        assert valid.sum() > 5
        assert np.array_equal(got["valid"][i].numpy(), valid)
        assert np.array_equal(got["labels"][i].numpy()[valid],
                              np.asarray(want["labels"])[valid])
        for key in ("boxes3d", "bboxes2d", "scores", "centers2d"):
            g, w = got[key][i].numpy(), np.asarray(want[key])
            err = np.abs(g[valid] - w[valid]).max()
            assert err <= 1e-4 * np.abs(w[valid]).max(), (i, key, err)
    # the two cameras place the same head output differently
    assert not torch.allclose(got["boxes3d"][0, :3], got["boxes3d"][1, :3])
    with pytest.raises(ValueError, match="cam_K"):
        decode_3ddet(batched, _t(Ks[:1].repeat(3, 0)), cfgs[1])


def _det_case(B=3, seed=2):
    """Seeded head outputs of a 64x128 batch (5 levels, 6 classes) and its
    padded ground truth (8 slots) from the synthetic set, image 1 without a
    labelled box."""
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    gt = SyntheticMT(("3ddet",), {"3ddet": 18}, (64, 128), seed=seed,
                     max_boxes=8).batch(0, B)
    gt = {k: v for k, v in gt.items() if k.startswith("det_")}
    gt["det_valid"][1] = 0.0
    rng = np.random.default_rng(seed)
    head = ([], [], [], [])
    for h, w in [(8, 16), (4, 8), (2, 4), (2, 4), (1, 2)]:
        head[0].append(rng.normal(size=(B, h, w, 6)).astype(np.float32) - 2)
        b = rng.normal(size=(B, h, w, 13)).astype(np.float32)
        b[..., 2] = np.exp(0.3 * b[..., 2]) * 20
        head[1].append(b)
        head[2].append(rng.normal(size=(B, h, w, 6)).astype(np.float32))
        head[3].append(rng.normal(size=(B, h, w, 1)).astype(np.float32))
    return head, gt


def test_detection_loss_matches_jax():
    """Targets, every loss component and the gradient of the total w.r.t.
    every head output against the JAX package, on a batch with a label-less
    image: labels equal, the rest rtol 1e-5 (gradients with a floor of 1e-5
    of their largest value)."""
    import jax
    from mtt_tpu.detection import det_model as jdm
    from mtt_tpu.detection.det_params import default_det_params as jmake
    from mtt_tpu_torch.detection import det_model as tdm
    from mtt_tpu_torch.detection.det_params import default_det_params
    head, gt = _det_case()
    jcfg, cfg = jmake(6), default_det_params(6)
    strides = tuple(cfg["strides"])
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}
    jhead = tuple([jnp.asarray(a) for a in lvl] for lvl in head)
    (jtotal, jparts), jgrad = jax.jit(jax.value_and_grad(
        lambda h: jdm.detection_loss(h, jgt, jcfg, strides), has_aux=True))(
            jhead)
    thead = tuple([_t(a).requires_grad_() for a in lvl] for lvl in head)
    total, parts = tdm.detection_loss(thead, {k: _t(v) for k, v in
                                              gt.items()}, cfg, strides)
    total.backward()
    assert parts.keys() == jparts.keys()
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for lg, lw in zip(thead, jgrad):
        for g, w in zip(lg, lw):
            w = np.asarray(w)
            np.testing.assert_allclose(g.grad.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
    # the label-less image leaves the class loss: its logits get no gradient
    assert all(lvl.grad[1].abs().max() == 0 for lvl in thead[0])

    # the targets themselves, the batch written out against the vmap
    pts, st, lvl = tdm.level_points(((8, 16), (4, 8), (2, 4), (2, 4), (1, 2)),
                                    strides)
    rr = torch.tensor(cfg["regress_ranges"], dtype=torch.float32)
    got = tdm.get_targets(pts, st, rr[lvl, 0], rr[lvl, 1],
                          {k[4:]: _t(v) for k, v in gt.items()}, cfg)
    jp, js, jl = jdm.level_points([(8, 16), (4, 8), (2, 4), (2, 4), (1, 2)],
                                  strides)
    jrr = jnp.asarray(jcfg["regress_ranges"], jnp.float32)
    want = jax.jit(jax.vmap(lambda g: jdm.get_targets_single(
        jp, js, jrr[jl, 0], jrr[jl, 1], g, jcfg)))(
            {k[4:]: v for k, v in jgt.items()})
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[0] < 6).sum() > 3 and (got[0][1] == 6).all()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())
    np.testing.assert_array_equal(
        tdm.direction_targets(got[1][..., 6:9].reshape(-1, 3)).numpy(),
        np.asarray(jdm.direction_targets(jnp.asarray(
            got[1][..., 6:9].reshape(-1, 3).numpy()))))


@pytest.mark.parametrize("name", ["sigmoid_focal_loss", "smooth_l1_loss",
                                  "softmax_ce_loss", "binary_ce_loss",
                                  "giou_loss"])
def test_det_losses_match_jax(name):
    """Each detection loss and its gradient w.r.t. the prediction, with an
    element weight and an average factor (the focal loss with background
    labels too): rtol 1e-5, gradients with a floor of 1e-6 of their scale."""
    import jax
    from mtt_tpu.detection import det_losses as jl
    from mtt_tpu_torch.detection import det_losses as tl
    rng = np.random.default_rng(3)
    n = 40
    w = rng.uniform(size=(n,)).astype(np.float32)
    if name == "sigmoid_focal_loss":
        pred = rng.normal(size=(n, 5)).astype(np.float32)
        tgt = rng.integers(0, 6, size=(n,))                 # 5: background
        assert (tgt == 5).any()
        kw = dict(num_classes=5, gamma=2.0, alpha=0.25, loss_weight=5.0)
        fj = lambda p: jl.sigmoid_focal_loss(p, jnp.asarray(tgt), weight=w,
                                             avg_factor=7.0, **kw)
        ft = lambda p: tl.sigmoid_focal_loss(p, torch.from_numpy(tgt),
                                             weight=_t(w), avg_factor=7.0,
                                             **kw)
    elif name == "softmax_ce_loss":
        pred = rng.normal(size=(n, 2)).astype(np.float32)
        tgt = rng.integers(0, 2, size=(n,))
        fj = lambda p: jl.softmax_ce_loss(p, jnp.asarray(tgt), weight=w,
                                          avg_factor=7.0)
        ft = lambda p: tl.softmax_ce_loss(p, torch.from_numpy(tgt),
                                          weight=_t(w), avg_factor=7.0)
    else:
        pred = rng.normal(size=(n, 4)).astype(np.float32)
        tgt = rng.normal(size=(n, 4)).astype(np.float32)
        if name == "giou_loss":       # xyxy boxes, some of them disjoint
            pred[:, 2:] = pred[:, :2] + np.abs(pred[:, 2:]) + 0.1
            tgt[:, 2:] = tgt[:, :2] + np.abs(tgt[:, 2:]) + 0.1
        if name == "binary_ce_loss":
            pred, tgt = pred[:, 0], rng.uniform(size=(n,)).astype(np.float32)
        ww = w if name in ("binary_ce_loss", "giou_loss") else w[:, None]
        fj = lambda p: getattr(jl, name)(p, jnp.asarray(tgt), weight=ww,
                                         avg_factor=7.0)
        ft = lambda p: getattr(tl, name)(p, _t(tgt), weight=_t(ww),
                                         avg_factor=7.0)
    want, gwant = jax.value_and_grad(fj)(jnp.asarray(pred))
    pt = _t(pred).requires_grad_()
    got = ft(pt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    gwant = np.asarray(gwant)
    np.testing.assert_allclose(pt.grad.numpy(), gwant, rtol=1e-5,
                               atol=1e-6 * np.abs(gwant).max())
    assert tl._reduce(_t(w)).item() == pytest.approx(float(w.mean()))


def test_deform_conv_grads_match_jax():
    """The deformable conv's gradient is autograd's through the gather and
    the K*C product: w.r.t. the input, the kernel and bias, and the offset
    and mask conv (so the sampling positions), against ``jax.grad`` in f32 at
    rtol 1e-5 with a floor of 1e-5 of each gradient's largest value."""
    import jax
    from mtt_tpu.ops.deform_conv import DeformConv2d as JDcn
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.ops.deform_conv import DeformConv2d
    x = _rand(0, 2, 6, 9, 8)
    cot = _rand(1, 2, 6, 9, 12)
    jm = JDcn(12)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    jg, jgx = jax.jit(jax.grad(lambda params, xx: jnp.sum(
        jm.apply({"params": params}, xx) * cot), argnums=(0, 1)))(
            v["params"], jnp.asarray(x))
    port = _load(DeformConv2d(8, 12), v)
    xt = _t(x).requires_grad_()
    (port(xt) * _t(cot)).sum().backward()
    want = state_dict_from_flax({"params": jg})
    got = {n: w.grad for n, w in port.named_parameters()}
    got["x"], want["x"] = xt.grad, jgx
    assert set(got) == {"x", "weight", "bias", "offset_mask.weight",
                        "offset_mask.bias"}
    for k in got:
        w = np.asarray(want[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
