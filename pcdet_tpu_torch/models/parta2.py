"""Part-A² detector: MeanVFE -> UNetV2 -> RPNV2 -> proposals -> (training:
the RoI sampler) -> RoI-aware pooling -> RCNN -> refined boxes and
class-agnostic NMS, or the UNet, anchor and RCNN losses.

Twin of `pcdet_tpu.models.parta2` (`PartA2Module`, `unet_loss`, the
`PartA2Net` wrapper's `forward`, `_stage2`, `loss` and `predict`), on
SECOND's wrapper: the same host books (`encoder_spec` at the UNet's caps:
the decoder takes the encoder's books and their transposes), anchors and
modes.  The proposal NMS, the sampler's RoI-GT IoU and the final NMS run
kernel A; the UNet's sparse convs run kernels B / C or, by `loads`, E /
E′, and in training their backward B / E / E′ and the dW kernels D / D″
/ D′.  Part-A²-fc is the same model with the FCRCNN head
(`MODEL.RCNN.NAME`).  The sampler and the RCNN's dropout draw from
`generator` (`set_generator`; the trainer's device generator).
"""
import numpy as np
import torch

from ..datasets.dataset import generate_voxel_part_targets
from ..ops import sparse
from ..ops.roiaware_pool import roiaware_pool3d_multi_batched
from ..parallel import ddp
from ..utils import loss as loss_ops
from .backbones3d import UNetV2
from .detector3d import detector_loss, post_process_batch
from .roi_heads import (FCRCNN, Dropout, SpConvRCNN, decode_rcnn_boxes,
                        proposal_layer_from_head, proposal_target_layer,
                        rcnn_loss)
from .second import SECONDNet, SECONDNetModule

# the modules of stage 1, which MODEL.RPN.PARAMS_FIXED freezes
STAGE1 = ('vfe', 'rpn_net', 'rpn_head')


def unet_loss(u_seg_preds, u_reg_preds, seg_labels, part_labels,
              group=None):
    """Focal segmentation loss and BCE part loss over the fg voxels
    (`pcdet_tpu.models.parta2.unet_loss`; the reference's
    rpn_unet.get_loss:109-143).  With a process `group`, the fg count
    `pos_norm` (and its `pos_norm > 0`) is the global batch's, summed over
    the ranks, so the loss is this rank's share of the global batch's;
    `rpn_pos_num` stays the rank's own count (the ranks' sum is the
    global one).

    :param u_seg_preds: (B, V, 1); :param u_reg_preds: (B, V, 3)
    :param seg_labels: (B, V) int32 (-1 ignore, 0 bg, class id fg)
    :param part_labels: (B, V, 3)
    """
    seg = u_seg_preds[..., 0]
    pos = (seg_labels > 0).to(torch.float32)
    neg = (seg_labels == 0).to(torch.float32)
    pos_num = pos.sum()
    pos_norm = ddp.all_sum(pos_num, group)
    weights = (pos + neg) / torch.clamp(pos_norm, min=1.0)
    cls_loss = loss_ops.sigmoid_focal_loss(
        seg[..., None], pos[..., None], weights, gamma=2.0,
        alpha=0.25).sum()
    p = torch.sigmoid(u_reg_preds)
    eps = 1e-7
    bce = -(part_labels * torch.log(torch.clamp(p, eps, 1.0))
            + (1 - part_labels) * torch.log(torch.clamp(1 - p, eps, 1.0)))
    # F.binary_cross_entropy's mean over the (P, 3) fg elements
    reg_loss = (bce * pos[..., None]).sum() / torch.clamp(pos_norm * 3.0,
                                                         min=1.0)
    loss = cls_loss + torch.where(pos_norm > 0, reg_loss, 0.0)
    return loss, {'rpn_loss_u_cls': cls_loss, 'rpn_u_loss_reg': reg_loss,
                  'rpn_loss_unet': loss, 'rpn_pos_num': pos_num}


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

    draws = True
    coord_targets = True

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
        self.params_fixed = bool(cfg.MODEL.RPN.get('PARAMS_FIXED', False))
        self.generator = None
        # the sampler's (B, ROI_PER_IMAGE) proposal indices to take instead
        # of drawing them; `last_sampler` holds the last draw and its counts
        self.fixed_picks = None
        self.last_sampler = None

    def set_generator(self, generator):
        """The torch.Generator (on this model's device) that the RoI sampler
        and the RCNN's dropouts draw from in training."""
        self.generator = generator
        for mod in self.module.modules():
            if isinstance(mod, Dropout):
                mod.generator = generator

    def frozen_prefixes(self):
        """Stage 1's modules under MODEL.RPN.PARAMS_FIXED, else none."""
        return STAGE1 if self.params_fixed else ()

    def host_targets(self, coords, gt_boxes):
        """The GT boxes (B, M, 8) f32 for the sampler and the per-voxel
        targets of the UNet loss, as the loader makes them
        (`datasets.dataset.generate_voxel_part_targets` on the voxel
        centres): seg_labels (B, V) int32, part_labels (B, V, 3) f32.
        Coords on the device are copied to the host here."""
        if torch.is_tensor(coords):
            coords = coords.cpu().numpy()
        data_cfg = self.cfg.DATA_CONFIG
        target_cfg = self.cfg.MODEL.RPN.BACKBONE.TARGET_CONFIG
        vs = np.asarray(data_cfg.VOXEL_GENERATOR.VOXEL_SIZE, np.float32)
        origin = np.asarray(data_cfg.POINT_CLOUD_RANGE[:3], np.float32)
        gt_boxes = np.ascontiguousarray(gt_boxes, np.float32)
        seg, part = [], []
        for c, g in zip(coords, gt_boxes):
            g = g[np.abs(g[:, :7]).sum(1) > 0]
            centers = (c[:, ::-1].astype(np.float32) + 0.5) * vs + origin
            s, p = generate_voxel_part_targets(
                centers, c[:, 0] >= 0, g[:, :7], g[:, 7].astype(np.int32),
                target_cfg)
            seg.append(s)
            part.append(p)
        return [('gt_boxes', gt_boxes), ('seg_labels', np.stack(seg)),
                ('part_labels', np.stack(part))]

    def dropouts(self):
        """The RCNN's Dropout modules, in module order."""
        return [m for m in self.module.modules() if isinstance(m, Dropout)]

    def make_module(self, args):
        return PartA2Module(self.rcnn_cfg, **args)

    def voxel_centers(self, coords):
        """(B, V, 3) ZYX coords -> (B, V, 3) xyz voxel centres."""
        return ((coords.flip(-1).to(torch.float32) + 0.5) * self.voxel_size
                + self.pc_origin)

    def proposals(self, ret, train=False):
        """The proposal layer on the RPN's outputs, detached, at TRAIN's or
        TEST's NMS_PRE_MAXSIZE, NMS_POST_MAXSIZE, RPN_NMS_THRESH and
        RPN_NMS_TYPE: {'rois', 'roi_raw_scores', 'roi_labels',
        'roi_valid'}."""
        tc = self.cfg.MODEL.TRAIN if train else self.cfg.MODEL.TEST
        b, a = ret['box_preds'].shape[0], self.anchors.shape[0]
        dir_preds = ret.get('dir_cls_preds')
        with torch.no_grad():
            return proposal_layer_from_head(
                ret['cls_preds'].reshape(b, a, -1),
                ret['box_preds'].reshape(b, a, -1), self.anchors,
                None if dir_preds is None else dir_preds.reshape(b, a, -1),
                self.box_coder, self.head_args,
                nms_pre=int(tc.NMS_PRE_MAXSIZE),
                nms_post=int(tc.NMS_POST_MAXSIZE),
                nms_thresh=float(tc.RPN_NMS_THRESH),
                rotated=str(tc.get('RPN_NMS_TYPE', 'nms_gpu'))
                != 'nms_normal_gpu')

    def pool(self, ret, batch, rois):
        """RoI-aware pooling of the part features (averaged) and the UNet's
        seg features (max) over the voxel centres: (B, N, o, o, o, 4), (B,
        N, o, o, o, 16) and the in-box voxels past ROI_MAX_PTS_PER_ROI.
        The part features are detached; the seg features are not, so the
        RCNN's loss reaches the UNet through the max."""
        rc = self.rcnn_cfg
        # part features: the part offsets' sigmoid where the seg score
        # passes SEG_MASK_SCORE_THRESH, and the seg score
        seg_scores = torch.sigmoid(ret['u_seg_preds'][..., 0].detach())
        part = torch.sigmoid(ret['u_reg_preds'].detach()) * (
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
        """Proposals -> (training: the RoI sampler and its targets against
        `batch['gt_boxes']`) -> RoI-aware pooling -> RCNN
        (`pcdet_tpu.models.parta2.PartA2Net._stage2`)."""
        train = self.training
        roi = self.proposals(ret, train)
        if train:
            targets = proposal_target_layer(
                roi, batch['gt_boxes'], self.rcnn_cfg.TARGET_CONFIG,
                self.num_class, self.generator, self.fixed_picks)
            self.last_sampler = targets.pop('sampler')
            roi = targets
        rois = roi['rois']
        pooled_part, pooled_rpn, pool_overflow = self.pool(ret, batch, rois)
        b, n = rois.shape[:2]
        rcnn_cls, rcnn_reg = self.module.rcnn_net(
            pooled_part.flatten(0, 1), pooled_rpn.flatten(0, 1))
        return dict(roi, rcnn_cls=rcnn_cls.reshape(b, n),
                    rcnn_reg=rcnn_reg.reshape(b, n, -1),
                    pool_overflow=pool_overflow)

    def forward(self, batch):
        """Both stages: SECOND's forward (the books from the batch), then
        `stage2`; `ret['rcnn']` holds its outputs (in training also the
        targets) and `ret['overflow']['roi_pts']` the RoI pool's capped
        points.  Under MODEL.RPN.PARAMS_FIXED stage 1 runs in training
        without a graph (its BN statistics still update, its losses are
        still computed), as the reference's forward_rpn does."""
        if self.training and self.params_fixed:
            with torch.no_grad():
                ret = super().forward(batch)
        else:
            ret = super().forward(batch)
        rcnn = self.stage2(ret, batch)
        ret['overflow'] = dict(ret['overflow'],
                               roi_pts=rcnn.pop('pool_overflow'))
        ret['rcnn'] = rcnn
        return ret

    def loss(self, ret_dict, batch):
        """The UNet, anchor and RCNN losses and the tb scalars under
        `pcdet_tpu`'s names, `overflow/*` included (`pcdet_tpu.models.
        parta2.PartA2Net.loss`; the reference's get_training_loss:
        128-161): batch carries the anchor targets, `seg_labels` (B, V)
        int32 and `part_labels` (B, V, 3).  Under a process group each
        term is the rank's share of the global batch's."""
        lw = self.cfg.MODEL.LOSSES.LOSS_WEIGHTS
        u_loss, tb = unet_loss(ret_dict['u_seg_preds'],
                               ret_dict['u_reg_preds'], batch['seg_labels'],
                               batch['part_labels'], self.process_group)
        rpn_loss, tb_rpn = detector_loss(self, ret_dict, batch)
        tb.update(tb_rpn)
        r_loss, tb_rcnn = rcnn_loss(
            ret_dict['rcnn'], loss_weights={
                'rcnn_cls_weight': float(lw['rcnn_cls_weight']),
                'rcnn_reg_weight': float(lw['rcnn_reg_weight']),
                'rcnn_corner_weight': float(lw.get('rcnn_corner_weight',
                                                   1.0)),
                'code_weights': list(lw['code_weights'])},
            corner_loss_regularization=bool(self.cfg.MODEL.LOSSES.get(
                'CORNER_LOSS_REGULARIZATION', True)),
            code_size=self.box_coder.code_size, group=self.process_group)
        tb.update(tb_rcnn)
        total = u_loss + rpn_loss + r_loss
        tb['loss'] = total
        return total, tb

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
