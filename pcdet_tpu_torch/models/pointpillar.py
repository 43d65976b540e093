"""PointPillar detector: PillarVFE -> BEV scatter -> RPNV2 -> predict or
the anchor-head loss.

Twin of `pcdet_tpu.models.pointpillar` (`PointPillarNet` and the
`PointPillar` wrapper): the stock loss, and under a MODE holding 'bev' the
fork's BEV segmentation head (`experiments.BEVSegHead` over RPNV2's
`spatial_features_last`, as `bev_seg_head`) and `loss_with_bev`, the
detection loss plus `experiments.bev_seg_loss` (additive: the fork's 1e-7
scaling of the detection loss is not reproduced).  Anchors and the training targets come from
`models/anchors.py` (`AnchorHeadTargets`, numpy, on the host).
`train_mode()` / `eval_mode()` switch BN between batch and running
statistics and the bf16 eval stack (`compute_dtype_test`) off and on, as
`train=` does in JAX.
"""
import numpy as np
import torch
import torch.nn as nn

from ..experiments import BEVSegHead, bev_seg_loss
from ..utils.box_coder import ResidualCoder
from ..utils.profiler import span
from .anchors import AnchorHeadTargets
from .detector3d import TrainHooks, detector_loss, post_process_from_head
from .layers import init_weights
from .pillar_scatter import pillar_scatter
from .rpn_head import RPNV2
from .vfe import PillarFeatureNet


class PointPillarNet(nn.Module):
    """voxels -> NHWC head outputs."""

    def __init__(self, num_class, num_anchors_per_location, grid_ny, grid_nx,
                 num_point_features, vfe_num_filters, vfe_with_distance,
                 voxel_size, pc_range, rpn_args, use_norm=True,
                 with_bev_seg=False, bev_num_classes=2, bev_out_size=200):
        super().__init__()
        self.grid_ny, self.grid_nx = grid_ny, grid_nx
        a = rpn_args
        # eval-only bf16 conv stack (the config's compute_dtype_test); the
        # canvas is cast before the scatter, which RPNV2 would do anyway
        bf16 = str(a.get('compute_dtype_test', '')) == 'bfloat16'
        self.canvas_dtype = (torch.bfloat16
                             if bf16 and not a.get('concat_input', False)
                             else None)
        self.vfe = PillarFeatureNet(
            num_input_features=num_point_features,
            num_filters=tuple(vfe_num_filters), use_norm=use_norm,
            with_distance=vfe_with_distance, voxel_size=tuple(voxel_size),
            pc_range=tuple(pc_range))
        self.rpn_head = RPNV2(
            num_class=num_class,
            num_anchors_per_location=num_anchors_per_location,
            num_input_features=vfe_num_filters[-1],
            layer_nums=tuple(a['layer_nums']),
            layer_strides=tuple(a['layer_strides']),
            num_filters=tuple(a['num_filters']),
            upsample_strides=tuple(a['upsample_strides']),
            num_upsample_filters=tuple(a['num_upsample_filters']),
            use_norm=a.get('use_norm', True),
            concat_input=a.get('concat_input', False),
            encode_background_as_zeros=a.get('encode_background_as_zeros',
                                             True),
            use_direction_classifier=a.get('use_direction_classifier', True),
            num_direction_bins=a.get('num_direction_bins', 2),
            compute_dtype=torch.bfloat16 if bf16 else None)
        self.bev_seg_head = None
        if with_bev_seg:
            self.bev_seg_head = BEVSegHead(self.rpn_head.c_head,
                                           bev_num_classes,
                                           out_size=bev_out_size)

    def forward(self, voxels, num_points, coords, voxel_mask):
        with span('pcdet.vfe'):
            features = self.vfe(voxels, num_points, coords, voxel_mask)
            if self.canvas_dtype is not None and not self.training:
                features = features.to(self.canvas_dtype)
            canvas = pillar_scatter(features, coords, voxel_mask,
                                    self.grid_ny, self.grid_nx)
        ret = self.rpn_head(canvas)
        if self.bev_seg_head is not None:
            ret['bev_seg_logits'] = self.bev_seg_head(
                ret['spatial_features_last'])
        return ret


class PointPillar(TrainHooks):
    """Detector wrapper: module + anchors + predict."""

    def __init__(self, cfg, grid_size, device='cuda', generator=None):
        self.cfg = cfg
        self.class_names = list(cfg.CLASS_NAMES)
        self.num_class = len(self.class_names)
        head_cfg = cfg.MODEL.RPN.RPN_HEAD
        self.head_args = dict(head_cfg.ARGS)
        self.box_coder = ResidualCoder()
        # targets are assigned on the host with the numpy coder
        targets = AnchorHeadTargets(head_cfg.TARGET_CONFIG,
                                    np.asarray(grid_size), self.class_names)
        self.anchor_targets = targets
        self.device = torch.device(device)
        self.anchors = torch.as_tensor(targets.anchors, device=self.device)
        vfe_args = cfg.MODEL.VFE.ARGS
        data_cfg = cfg.DATA_CONFIG
        self.with_bev_seg = 'bev' in str(cfg.get('MODE', ''))
        self.module = PointPillarNet(
            num_class=self.num_class,
            num_anchors_per_location=targets.num_anchors_per_location,
            grid_ny=int(grid_size[1]), grid_nx=int(grid_size[0]),
            num_point_features=int(data_cfg.NUM_POINT_FEATURES['use']),
            vfe_num_filters=tuple(vfe_args['num_filters']),
            vfe_with_distance=bool(vfe_args.get('with_distance', False)),
            voxel_size=tuple(data_cfg.VOXEL_GENERATOR.VOXEL_SIZE),
            pc_range=tuple(data_cfg.POINT_CLOUD_RANGE),
            rpn_args=self.head_args,
            use_norm=bool(vfe_args.get('use_norm', True)),
            with_bev_seg=self.with_bev_seg)
        if generator is not None:
            init_weights(self.module, generator)
            self.module.rpn_head.init_focal_bias(0.01)
        # the canvas is NHWC, so the convolutions run channels-last
        self.module.eval().to(self.device, memory_format=torch.channels_last)

    @property
    def training(self):
        return self.module.training

    def train_mode(self):
        """BN on batch statistics, the f32 canvas and RPN."""
        self.module.train()
        return self

    def eval_mode(self):
        """BN on running statistics, `compute_dtype_test`."""
        self.module.eval()
        return self

    def forward(self, batch):
        return self.module(batch['voxels'], batch['num_points_per_voxel'],
                           batch['coordinates'], batch['voxel_mask'])

    def loss(self, ret_dict, batch):
        """Anchor-head loss and tb scalars, `overflow/voxelizer` included
        (`pcdet_tpu.models.pointpillar.PointPillar.loss`): batch carries
        `box_cls_labels` (B, A) int32 and `box_reg_targets` (B, A, 7)."""
        return detector_loss(self, ret_dict, batch)

    def loss_with_bev(self, ret_dict, batch):
        """`loss` plus `bev_seg_loss` of the BEV logits against batch['bev']
        (B, 200, 200, C) when MODE asks for the head and the batch carries
        the masks; `loss` and the BEV scalars in the tb dict."""
        loss, tb = self.loss(ret_dict, batch)
        if self.with_bev_seg and 'bev' in batch:
            bev_loss, tb_bev = bev_seg_loss(ret_dict['bev_seg_logits'],
                                            batch['bev'], self.process_group)
            tb.update(tb_bev)
            loss = loss + bev_loss
            tb['loss'] = loss
        return loss, tb

    def predict(self, ret_dict):
        """Decoded, NMS'd fixed-shape predictions (B, post_max, ...)."""
        return post_process_from_head(
            ret_dict, self.anchors, self.box_coder, self.num_class,
            self.head_args, self.cfg.MODEL.TEST)
