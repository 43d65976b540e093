"""SECOND detector (eval): MeanVFE -> BackBone8x sparse convs -> RPNV2 -> predict.

Twin of `pcdet_tpu.models.second` (`SECONDNetModule` and the `SECONDNet`
wrapper).  The sparse backbone runs over host-built rulebooks
(`ops/host_books.py`) that `forward` takes from the batch: `books`, decoded
on the device, or the loader's `hb_*` wire arrays.  Anchors come from
`pcdet_tpu.models.anchors.AnchorHeadTargets` (numpy, framework-free).
"""
import numpy as np
import torch
import torch.nn as nn

from pcdet_tpu.models.anchors import AnchorHeadTargets

from ..ops import host_books, sparse
from ..utils.box_coder import ResidualCoder
from .backbones3d import BackBone8x, effective_dtype, resolve_caps
from .detector3d import post_process_from_head
from .layers import init_weights
from .rpn_head import RPNV2
from .vfe import MeanVFE


class SECONDNetModule(nn.Module):
    """voxels + books -> NHWC head outputs, BEV and per-level drops."""

    def __init__(self, num_class, num_anchors_per_location, sparse_shape,
                 last_pad, num_point_features, backbone_args, rpn_args):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.compute_dtype = effective_dtype(backbone_args)
        a = rpn_args
        self.vfe = MeanVFE()
        self.rpn_net = BackBone8x(num_point_features, last_pad)
        bev_channels = 128 * BackBone8x.out_depth(sparse_shape, last_pad)
        bf16 = str(a.get('compute_dtype_test', '')) == 'bfloat16'
        self.rpn_head = RPNV2(
            num_class=num_class,
            num_anchors_per_location=num_anchors_per_location,
            num_input_features=bev_channels,
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

    def forward(self, voxels, num_points, coords, voxel_mask, books):
        feats = self.vfe(voxels, num_points, coords, voxel_mask)
        level = sparse.from_voxelizer(feats, coords, voxel_mask,
                                      self.sparse_shape)
        bev, overflow = self.rpn_net(level, books, self.compute_dtype)
        ret = self.rpn_head(bev)
        ret['spatial_features'] = bev
        ret['overflow'] = overflow
        return ret


class SECONDNet:
    """Detector wrapper: module + anchors + host book spec + predict."""

    def __init__(self, cfg, grid_size, device='cpu', generator=None):
        self.cfg = cfg
        self.class_names = list(cfg.CLASS_NAMES)
        self.num_class = len(self.class_names)
        # spconv convention: the sparse z gets one extra slot
        self.sparse_shape = (int(grid_size[2]) + 1, int(grid_size[1]),
                             int(grid_size[0]))
        head_cfg = cfg.MODEL.RPN.RPN_HEAD
        self.head_args = dict(head_cfg.ARGS)
        self.box_coder = ResidualCoder()
        targets = AnchorHeadTargets(head_cfg.TARGET_CONFIG,
                                    np.asarray(grid_size), self.class_names)
        self.device = torch.device(device)
        self.anchors = torch.as_tensor(targets.anchors, device=self.device)
        vz = cfg.DATA_CONFIG.VOXEL_GENERATOR.VOXEL_SIZE[-1]
        self.last_pad = (0, 0, 0) if vz in [0.1, 0.2] else (1, 0, 0)
        self.backbone_args = dict(cfg.MODEL.RPN.BACKBONE.get('ARGS', {}))
        self.module = SECONDNetModule(
            num_class=self.num_class,
            num_anchors_per_location=targets.num_anchors_per_location,
            sparse_shape=self.sparse_shape, last_pad=self.last_pad,
            num_point_features=int(cfg.DATA_CONFIG.NUM_POINT_FEATURES['use']),
            backbone_args=self.backbone_args, rpn_args=self.head_args)
        if generator is not None:
            init_weights(self.module, generator)
            self.module.rpn_head.init_focal_bias(0.01)
        self.module.eval().to(self.device)
        # the BEV is NHWC, so the head's convolutions run channels-last
        self.module.rpn_head.to(memory_format=torch.channels_last)

    def host_book_spec(self, input_cap):
        """`encoder_spec` at this model's eval caps for `input_cap` voxels."""
        a = self.backbone_args
        absolute = a.get('level_caps_test') or a.get('level_caps', (0, 0, 0))
        caps = resolve_caps(int(input_cap), tuple(absolute),
                            tuple(a.get('level_caps_frac', (0.,) * 4)))
        return host_books.encoder_spec(self.sparse_shape, caps, self.last_pad)

    def build_books(self, coords):
        """Host books of a batch from its (B, V, 3) coords (numpy, -1 rows
        for padding voxels): the `hb_*` wire arrays."""
        coords = np.asarray(coords)
        return host_books.build_books_batch(
            coords, coords[..., 0] >= 0, self.sparse_shape,
            self.host_book_spec(coords.shape[1]))

    def upload_books(self, flat, input_cap):
        return host_books.upload_books(flat, self.host_book_spec(input_cap),
                                       input_cap, self.device)

    def forward(self, batch):
        """:param batch: voxelizer outputs plus the books: `books` (decoded,
        on the device) or the loader's `hb_*` wire arrays."""
        books = batch.get('books')
        if books is None:
            books = self.upload_books(
                {k: v for k, v in batch.items() if k.startswith('hb_')},
                batch['coordinates'].shape[1])
        return self.module(batch['voxels'], batch['num_points_per_voxel'],
                           batch['coordinates'], batch['voxel_mask'], books)

    def predict(self, ret_dict):
        """Decoded, NMS'd fixed-shape predictions (B, post_max, ...)."""
        return post_process_from_head(
            ret_dict, self.anchors, self.box_coder, self.num_class,
            self.head_args, self.cfg.MODEL.TEST)
