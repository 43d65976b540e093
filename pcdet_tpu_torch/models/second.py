"""SECOND detector: MeanVFE -> BackBone8x sparse convs -> RPNV2 -> predict
or the anchor-head loss.

Twin of `pcdet_tpu.models.second` (`SECONDNetModule` and the `SECONDNet`
wrapper).  The sparse backbone runs over rulebooks that `forward` takes
from the batch: `books`, decoded on the device, or the loader's `hb_*` wire
arrays (`ops/host_books.py`); a batch with neither gets books built on the
device from its coords under PCDET_HOST_BOOKS=0 (`device_books`), as the
JAX backbone builds absent books in the step.  Anchors and the
training targets come from `models/anchors.py` (`AnchorHeadTargets`,
numpy, on the host).  `train_mode()` / `eval_mode()` switch the caps, the
compute dtypes and BN between the two, as `train=` does in JAX.  `loads`
(`ops/sparse.Loads`) chooses how the sparse convs load their rows.
"""
import numpy as np
import torch
import torch.nn as nn

from ..ops import host_books, sparse
from ..utils.box_coder import ResidualCoder
from ..utils.profiler import span
from .anchors import AnchorHeadTargets
from .backbones3d import BackBone8x, effective_dtype, resolve_caps
from .detector3d import TrainHooks, detector_loss, post_process_from_head
from .layers import init_weights
from .rpn_head import RPNV2
from .vfe import MeanVFE


class SECONDNetModule(nn.Module):
    """voxels + books -> NHWC head outputs, BEV and per-level drops.
    `BACKBONE`: the sparse backbone's class (Part-A²'s module takes its
    UNet)."""

    BACKBONE = BackBone8x

    def __init__(self, num_class, num_anchors_per_location, sparse_shape,
                 last_pad, num_point_features, backbone_args, rpn_args,
                 loads=None):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.train_dtype = effective_dtype(backbone_args, train=True)
        self.eval_dtype = effective_dtype(backbone_args, train=False)
        a = rpn_args
        self.vfe = MeanVFE()
        self.rpn_net = self.BACKBONE(num_point_features, last_pad, loads)
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

    @property
    def compute_dtype(self):
        """The sparse conv stack's dtype in the current mode (None: f32)."""
        return self.train_dtype if self.training else self.eval_dtype

    def forward(self, voxels, num_points, coords, voxel_mask, books):
        with span('pcdet.vfe'):
            feats = self.vfe(voxels, num_points, coords, voxel_mask)
        level = sparse.from_voxelizer(feats, coords, voxel_mask,
                                      self.sparse_shape)
        bev, overflow = self.rpn_net(level, books, self.compute_dtype)
        ret = self.rpn_head(bev)
        ret['spatial_features'] = bev
        ret['overflow'] = overflow
        return ret


class SECONDNet(TrainHooks):
    """Detector wrapper: module + anchors + host book spec + predict.

    :param loads: `ops.sparse.Loads` of the backbone's kw=3 convs (None:
        `BackBone8x`'s default)
    """

    def __init__(self, cfg, grid_size, device='cuda', generator=None,
                 loads=None):
        self.cfg = cfg
        self.class_names = list(cfg.CLASS_NAMES)
        self.num_class = len(self.class_names)
        # spconv convention: the sparse z gets one extra slot
        self.sparse_shape = (int(grid_size[2]) + 1, int(grid_size[1]),
                             int(grid_size[0]))
        head_cfg = cfg.MODEL.RPN.RPN_HEAD
        self.head_args = dict(head_cfg.ARGS)
        self.box_coder = ResidualCoder()
        # targets are assigned on the host with the numpy coder
        targets = AnchorHeadTargets(head_cfg.TARGET_CONFIG,
                                    np.asarray(grid_size), self.class_names)
        self.anchor_targets = targets
        self.device = torch.device(device)
        self.anchors = torch.as_tensor(targets.anchors, device=self.device)
        vz = cfg.DATA_CONFIG.VOXEL_GENERATOR.VOXEL_SIZE[-1]
        self.last_pad = (0, 0, 0) if vz in [0.1, 0.2] else (1, 0, 0)
        self.backbone_args = dict(cfg.MODEL.RPN.BACKBONE.get('ARGS', {}))
        self.module = self.make_module(dict(
            num_class=self.num_class,
            num_anchors_per_location=targets.num_anchors_per_location,
            sparse_shape=self.sparse_shape, last_pad=self.last_pad,
            num_point_features=int(cfg.DATA_CONFIG.NUM_POINT_FEATURES['use']),
            backbone_args=self.backbone_args, rpn_args=self.head_args,
            loads=loads))
        if generator is not None:
            init_weights(self.module, generator)
            self.module.rpn_head.init_focal_bias(0.01)
        self.module.eval().to(self.device)
        # the BEV is NHWC, so the head's convolutions run channels-last
        self.module.rpn_head.to(memory_format=torch.channels_last)

    def make_module(self, args):
        """The torch module from `SECONDNetModule`'s keyword arguments."""
        return SECONDNetModule(**args)

    @property
    def training(self):
        return self.module.training

    def train_mode(self):
        """Train caps, `compute_dtype`, BN on batch statistics."""
        self.module.train()
        return self

    def eval_mode(self):
        """Eval caps, `compute_dtype_test`, BN on running statistics."""
        self.module.eval()
        return self

    def host_book_spec(self, input_cap, train=False):
        """`encoder_spec` at this model's train or eval caps for `input_cap`
        voxels: `level_caps` in train, `level_caps_test` (else
        `level_caps`) in eval (`pcdet_tpu.models.second.host_book_spec`)."""
        a = self.backbone_args
        train_caps = a.get('level_caps', (0, 0, 0))
        absolute = (train_caps if train or not a.get('level_caps_test')
                    else a['level_caps_test'])
        caps = resolve_caps(int(input_cap), tuple(absolute),
                            tuple(a.get('level_caps_frac', (0.,) * 4)))
        return host_books.encoder_spec(self.sparse_shape, caps, self.last_pad)

    def build_books(self, coords, train=None):
        """Host books of a batch from its (B, V, 3) coords (numpy, -1 rows
        for padding voxels): the `hb_*` wire arrays, at the current mode's
        caps unless `train` says which."""
        train = self.training if train is None else train
        coords = np.asarray(coords)
        return host_books.build_books_batch(
            coords, coords[..., 0] >= 0, self.sparse_shape,
            self.host_book_spec(coords.shape[1], train))

    def upload_books(self, flat, input_cap, train=None):
        """Decoded device books of `build_books`' wire arrays, one copy."""
        train = self.training if train is None else train
        return host_books.upload_books(
            flat, self.host_book_spec(input_cap, train), input_cap,
            self.device)

    def device_books(self, coords, train=None):
        """The books of `build_books`, built where the (B, V, 3) coords lie
        (-1 rows for padding voxels) and decoded, at the current mode's
        caps unless `train` says which (`host_books.build_books_device`):
        no host copy."""
        train = self.training if train is None else train
        return host_books.build_books_device(
            coords, coords[..., 0] >= 0, self.sparse_shape,
            self.host_book_spec(coords.shape[1], train))

    def forward(self, batch):
        """:param batch: voxelizer outputs plus the books: `books` (decoded,
        on the device) or the loader's `hb_*` wire arrays; with neither,
        under PCDET_HOST_BOOKS=0, `device_books` of its coordinates."""
        books = batch.get('books')
        wire = {k: v for k, v in batch.items() if k.startswith('hb_')}
        if books is None and not wire and not host_books.use_host_books():
            books = self.device_books(batch['coordinates'])
        elif books is None:
            books = self.upload_books(wire, batch['coordinates'].shape[1])
        return self.module(batch['voxels'], batch['num_points_per_voxel'],
                           batch['coordinates'], batch['voxel_mask'], books)

    def loss(self, ret_dict, batch):
        """Anchor-head loss and tb scalars, `overflow/*` included
        (`pcdet_tpu.models.second.SECONDNet.loss`): batch carries
        `box_cls_labels` (B, A) int32 and `box_reg_targets` (B, A, 7)."""
        return detector_loss(self, ret_dict, batch)

    def predict(self, ret_dict):
        """Decoded, NMS'd fixed-shape predictions (B, post_max, ...)."""
        return post_process_from_head(
            ret_dict, self.anchors, self.box_coder, self.num_class,
            self.head_args, self.cfg.MODEL.TEST)
