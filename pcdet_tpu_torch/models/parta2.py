"""Part-A² detector, eval: MeanVFE -> UNetV2 -> RPNV2 -> proposals ->
RoI-aware pooling -> RCNN -> refined boxes -> class-agnostic NMS.

Twin of `pcdet_tpu.models.parta2` (`PartA2Module`, the `PartA2Net` wrapper's
eval `forward`, `_stage2`'s test branch and `predict`), on SECOND's wrapper:
the same host books (`encoder_spec` at the UNet's caps: the decoder takes
the encoder's books and their transposes), anchors and modes.  The
proposal NMS and the final NMS run kernel A; the UNet's sparse convs run
kernels B / C or, by `loads`, E / E′.  Part-A²-fc is the same model with
the FCRCNN head (`MODEL.RCNN.NAME`).  Training (the proposal target
layer, the UNet and RCNN losses) is not ported yet: `loss` and a forward
in train mode raise.
"""
import torch

from ..ops import sparse
from ..ops.roiaware_pool import roiaware_pool3d_multi_batched
from .backbones3d import UNetV2
from .detector3d import post_process_batch
from .roi_heads import (FCRCNN, SpConvRCNN, decode_rcnn_boxes,
                        proposal_layer_from_head)
from .second import SECONDNet, SECONDNetModule

TRAINING = ('Part-A2 training (proposal_target_layer, rcnn_loss, unet_loss) '
            'is not ported yet (ROADMAP.md queue 1)')


class PartA2Module(SECONDNetModule):
    """Stage 1 (voxels + books -> the RPN's NHWC head outputs, the BEV, the
    strided convs' drops and the UNet's per-voxel `u_seg_preds`,
    `u_reg_preds`, `seg_features`) and, as `rcnn_net`, stage 2's RCNN."""

    BACKBONE = UNetV2

    def __init__(self, rcnn_cfg, **args):
        super().__init__(**args)
        rc = rcnn_cfg
        head = SpConvRCNN if rc.NAME == 'SpConvRCNN' else FCRCNN
        self.rcnn_net = head(
            num_point_features=int(rc.NUM_POINT_FEATURES),
            shared_fc=tuple(rc.SHARED_FC), cls_fc=tuple(rc.CLS_FC),
            reg_fc=tuple(rc.REG_FC), dp_ratio=float(rc.DP_RATIO),
            pool_size=int(rc.ROI_AWARE_POOL_SIZE),
            compute_dtype_test=str(rc.get('compute_dtype_test', '')))

    def forward(self, voxels, num_points, coords, voxel_mask, books):
        feats = self.vfe(voxels, num_points, coords, voxel_mask)
        level = sparse.from_voxelizer(feats, coords, voxel_mask,
                                      self.sparse_shape)
        bev, overflow, unet = self.rpn_net(level, books, self.compute_dtype)
        ret = self.rpn_head(bev)
        ret['spatial_features'] = bev
        ret['overflow'] = overflow
        ret.update(unet)
        return ret


class PartA2Net(SECONDNet):
    """Detector wrapper: SECOND's (anchors, host book spec, modes) with
    Part-A²'s module, the second stage and its predict.

    :param loads: `ops.sparse.Loads` of the UNet's kw=3 convs (None: the
        backbone's default)
    """

    def __init__(self, cfg, grid_size, device='cuda', generator=None,
                 loads=None):
        self.rcnn_cfg = cfg.MODEL.RCNN
        super().__init__(cfg, grid_size, device=device, generator=generator,
                         loads=loads)
        data_cfg = cfg.DATA_CONFIG
        self.voxel_size = torch.tensor(data_cfg.VOXEL_GENERATOR.VOXEL_SIZE,
                                       dtype=torch.float32,
                                       device=self.device)
        self.pc_origin = torch.tensor(data_cfg.POINT_CLOUD_RANGE[:3],
                                      dtype=torch.float32, device=self.device)
        self.seg_mask_score_thresh = float(
            cfg.MODEL.RPN.BACKBONE.get('SEG_MASK_SCORE_THRESH', 0.3))

    def make_module(self, args):
        return PartA2Module(self.rcnn_cfg, **args)

    def voxel_centers(self, coords):
        """(B, V, 3) ZYX coords -> (B, V, 3) xyz voxel centres."""
        return ((coords.flip(-1).to(torch.float32) + 0.5) * self.voxel_size
                + self.pc_origin)

    def proposals(self, ret):
        """The proposal layer on the RPN's outputs at TEST's NMS_PRE_MAXSIZE,
        NMS_POST_MAXSIZE, RPN_NMS_THRESH and RPN_NMS_TYPE: {'rois',
        'roi_raw_scores', 'roi_labels', 'roi_valid'}."""
        tc = self.cfg.MODEL.TEST
        b, a = ret['box_preds'].shape[0], self.anchors.shape[0]
        dir_preds = ret.get('dir_cls_preds')
        return proposal_layer_from_head(
            ret['cls_preds'].reshape(b, a, -1),
            ret['box_preds'].reshape(b, a, -1), self.anchors,
            None if dir_preds is None else dir_preds.reshape(b, a, -1),
            self.box_coder, self.head_args,
            nms_pre=int(tc.NMS_PRE_MAXSIZE), nms_post=int(tc.NMS_POST_MAXSIZE),
            nms_thresh=float(tc.RPN_NMS_THRESH),
            rotated=str(tc.get('RPN_NMS_TYPE', 'nms_gpu')) != 'nms_normal_gpu')

    def pool(self, ret, batch, rois):
        """RoI-aware pooling of the part features (averaged) and the UNet's
        seg features (max) over the voxel centres: (B, N, o, o, o, 4), (B,
        N, o, o, o, 16) and the in-box voxels past ROI_MAX_PTS_PER_ROI."""
        rc = self.rcnn_cfg
        # part features: the part offsets' sigmoid where the seg score
        # passes SEG_MASK_SCORE_THRESH, and the seg score
        seg_scores = torch.sigmoid(ret['u_seg_preds'][..., 0])
        part = torch.sigmoid(ret['u_reg_preds']) * (
            seg_scores > self.seg_mask_score_thresh)[..., None].to(
                seg_scores.dtype)
        part_features = torch.cat([part, seg_scores[..., None]], dim=-1)
        (pooled_part, pooled_rpn), overflow = roiaware_pool3d_multi_batched(
            rois[..., :7], self.voxel_centers(batch['coordinates']),
            [(part_features, 'avg'), (ret['seg_features'], 'max')],
            batch['voxel_mask'], out_size=int(rc.ROI_AWARE_POOL_SIZE),
            max_pts_per_roi=int(rc.get('ROI_MAX_PTS_PER_ROI', 512)),
            return_overflow=True)
        return pooled_part, pooled_rpn, overflow

    def stage2(self, ret, batch):
        """Proposals -> RoI-aware pooling -> RCNN, eval
        (`pcdet_tpu.models.parta2.PartA2Net._stage2`, train=False)."""
        roi = self.proposals(ret)
        rois = roi['rois']
        pooled_part, pooled_rpn, pool_overflow = self.pool(ret, batch, rois)
        b, n = rois.shape[:2]
        rcnn_cls, rcnn_reg = self.module.rcnn_net(
            pooled_part.flatten(0, 1), pooled_rpn.flatten(0, 1))
        return dict(roi, rcnn_cls=rcnn_cls.reshape(b, n),
                    rcnn_reg=rcnn_reg.reshape(b, n, -1),
                    pool_overflow=pool_overflow)

    def forward(self, batch):
        """Both stages, eval: SECOND's forward (the books from the batch),
        then `stage2`; `ret['rcnn']` holds its outputs and
        `ret['overflow']['roi_pts']` the RoI pool's capped points."""
        if self.training:
            raise NotImplementedError(TRAINING)
        ret = super().forward(batch)
        rcnn = self.stage2(ret, batch)
        ret['overflow'] = dict(ret['overflow'],
                               roi_pts=rcnn.pop('pool_overflow'))
        ret['rcnn'] = rcnn
        return ret

    def loss(self, ret_dict, batch):
        raise NotImplementedError(TRAINING)

    def predict(self, ret_dict):
        """RCNN-refined boxes -> class-agnostic NMS with the RoIs' labels;
        padded RoI slots never surface (`pcdet_tpu.models.parta2.
        PartA2Net.predict`)."""
        rcnn = ret_dict['rcnn']
        boxes = decode_rcnn_boxes(rcnn['rcnn_reg'], rcnn['rois'],
                                  self.box_coder, self.box_coder.code_size)
        cls_preds = torch.where(rcnn['roi_valid'], rcnn['rcnn_cls'],
                                -1e9)[..., None]
        return post_process_batch(cls_preds, boxes, self.cfg.MODEL.TEST,
                                  class_labels_override=rcnn['roi_labels'])
