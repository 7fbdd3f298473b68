"""FCOS3D-style detection hyper-parameters for Cityscapes-3D (the values of
mtt_tpu/detection/det_params.py ``default_det_params``, as plain dicts),
with the losses' settings and ``max_boxes``, the fixed number of ground-truth
slots a training image carries."""

from __future__ import annotations

INF = 1e8


def default_det_params(num_classes: int = 6) -> dict:
    return dict(
        num_classes=num_classes,
        bbox_code_size=9,
        strides=(8, 16, 32, 32, 64),
        fpn_scale_no=5,
        regress_ranges=((-1, 96), (96, 192), (192, 384), (384, 768),
                        (768, INF)),
        center_sampling=True,
        center_sample_radius=1.5,
        norm_on_bbox=True,
        centerness_alpha=2.5,
        use_direction_classifier=True,
        diff_rad_by_sin=True,
        dir_offset=0,
        pred_bbox2d=True,
        pred_keypoints=False,
        group_reg_dims=(2, 1, 3, 3, 4),     # offset, depth, size, rot, bbox2d
        code_weight=(1.0, 1.0, 0.2, 1.0, 1.0, 1.0, 5.0, 5.0, 5.0, 1.0, 1.0,
                     1.0, 1.0),
        # losses
        loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                      alpha=0.25, loss_weight=5.0),
        loss_dir=dict(type="CrossEntropyLoss", use_sigmoid=False,
                      loss_weight=1.0),
        loss_bbox=dict(type="SmoothL1Loss", beta=1.0 / 9.0, loss_weight=1.0),
        loss_centerness=dict(type="CrossEntropyLoss", use_sigmoid=True,
                             loss_weight=1.0),
        loss_bbox2d=dict(type="SmoothL1Loss", beta=1.0 / 9.0,
                         loss_weight=1.0),
        loss_consistency=dict(type="GIoULoss", loss_weight=1.0),
        # head topology
        stacked_convs=3,
        in_channels=256,
        feat_channels=256,
        centerness_on_reg=True,
        dcn_on_last_conv=True,
        conv_bias=True,
        reg_branch=((256,), (256,), (256,), (256,), (256,)),
        centerness_branch=(256,),
        cls_branch=(256, 128),
        dir_branch=(256,),
        norm_groups=32,
        neck=dict(out_channels=256, start_level=0,
                  add_extra_convs="on_output", num_outs=5,
                  relu_before_extra_convs=True),
        test_cfg=dict(use_rotate_nms=True, nms_across_levels=False,
                      nms_pre=1000, nms_thr=0.3, score_thr=0.05,
                      min_bbox_size=0, max_per_img=200),
        # fixed-capacity padding of the ragged ground-truth boxes
        max_boxes=64,
    )
