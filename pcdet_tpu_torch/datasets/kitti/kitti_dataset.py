"""KITTI dataset: raw IO, info generation, GT database, examples, eval glue.

The port's copy of `pcdet_tpu.datasets.kitti.kitti_dataset` (the
reference's BaseKittiDataset, KittiDataset and create_kitti_infos):
fixed-shape examples (`datasets/dataset.py`); calib objects never enter the
batch, predictions go back to the camera and image frames through the
sample's info, looked up by sample_idx; the fork's PERCENT_OF_PTS,
ALTERNATE_PT_CLOUD_ABS_DIR, TAG_PTS_IF_IN_GT_BBOXES, TAG_PTS_WITH_RGB
(`get_colored_lidar`) and MODE 'bev' (`get_bev`, the BEV segmentation
masks as `bev` (200, 200, 2) in each example) are honoured.  Images are
read without PIL: a shape from the PNG header (`png_shape`), the BEV masks'
pixels by `read_png` (zlib and struct).
"""
import copy
import os
import pickle
import struct
import zlib
from pathlib import Path

import numpy as np

from ...utils import box_np_ops, common
from ...utils.calibration import Calibration
from ...utils.object3d import get_objects_from_label
from ..dataset import DatasetTemplate


def png_shape(path):
    """(height, width) int32 of a PNG, from its IHDR chunk."""
    with open(path, 'rb') as f:
        head = f.read(24)
    if head[:8] != b'\x89PNG\r\n\x1a\n' or head[12:16] != b'IHDR':
        raise ValueError('%s is not a PNG file' % path)
    width, height = struct.unpack('>II', head[16:24])
    return np.array([height, width], dtype=np.int32)


# (colour type, bit depth) -> channels, for what `read_png` decodes: grey
# (1 and 8 bit), RGB, palette indices, grey + alpha, RGBA
_PNG_CHANNELS = {(0, 1): 1, (0, 8): 1, (2, 8): 3, (3, 8): 1, (4, 8): 2,
                 (6, 8): 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data, height, stride, bpp):
    """The PNG scanline filters undone: (height, stride) uint8."""
    rows = np.frombuffer(data, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError('PNG image data holds %d bytes, want %d'
                         % (rows.size, height * (stride + 1)))
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = raw.copy()
        elif kind == 1:                                    # Sub
            cur = np.zeros(stride, np.uint8)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(raw[c::bpp], dtype=np.uint64) % 256
        elif kind == 2:                                    # Up
            cur = raw + prior
        elif kind in (3, 4):                               # Average, Paeth
            cur = bytearray(raw.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xff
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError('PNG scanline filter %d does not exist' % kind)
        out[y] = prior = cur
    return out


def read_png(path):
    """A PNG's pixels as `np.array(PIL.Image.open(path))` gives them: (H, W)
    uint8 for 8-bit grey and palette images (the indices), (H, W) bool for
    1-bit grey, (H, W, 3 / 2 / 4) uint8 for RGB, grey + alpha and RGBA.

    :raises ValueError: any other bit depth or colour type (16-bit ones
        included), an interlaced image, or a file that is not a PNG
    """
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError('%s is not a PNG file' % path)
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif tag == b'IDAT':
            idat.append(body)
        elif tag == b'IEND':
            break
    if header is None:
        raise ValueError('%s has no IHDR chunk' % path)
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError('%s is interlaced: not decoded' % path)
    channels = _PNG_CHANNELS.get((colour, depth))
    if channels is None:
        raise ValueError('%s: colour type %d at %d bits is not decoded'
                         % (path, colour, depth))
    stride = (width * channels * depth + 7) // 8
    pixels = _unfilter(zlib.decompress(b''.join(idat)), height, stride,
                       max(1, channels * depth // 8))
    if depth == 1:
        return np.unpackbits(pixels, axis=1)[:, :width].astype(bool)
    pixels = pixels.reshape(height, width, channels)
    return pixels[..., 0] if channels == 1 else pixels


class KittiDataset(DatasetTemplate):
    def __init__(self, cfg, training=True, logger=None, split=None,
                 root_path=None, for_info_generation=False):
        super().__init__(cfg, cfg.CLASS_NAMES, training)
        self.logger = logger
        self.for_info_generation = for_info_generation
        self.root_path = root_path or os.path.join(cfg.ROOT_DIR,
                                                   cfg.DATA_CONFIG.DATA_DIR)
        self.split = split or cfg.MODEL[self.mode].SPLIT
        self.root_split_path = os.path.join(
            self.root_path, 'training' if self.split != 'test' else 'testing')
        split_file = os.path.join(self.root_path, 'ImageSets',
                                  self.split + '.txt')
        self.sample_id_list = ([x.strip() for x in open(split_file).readlines()]
                               if os.path.exists(split_file) else None)

        self.kitti_infos = []
        if not for_info_generation:
            self.include_kitti_data(self.mode, logger)
            self.dataset_init(logger)
        self._info_by_idx = {info['point_cloud']['lidar_idx']: info
                             for info in self.kitti_infos}

    def set_split(self, split):
        self.__init__(self.cfg, self.training, self.logger, split=split,
                      root_path=self.root_path,
                      for_info_generation=self.for_info_generation)

    # ----------------------------------------------------------------- raw IO
    def get_lidar(self, idx):
        cfg = self.cfg
        if cfg.get('ALTERNATE_PT_CLOUD_ABS_DIR', ''):
            lidar_dir = cfg.ALTERNATE_PT_CLOUD_ABS_DIR
        else:
            lidar_dir = os.path.join(self.root_split_path, 'velodyne')
        lidar_file = os.path.join(lidar_dir, '%s.bin' % idx)
        assert os.path.exists(lidar_file), lidar_file
        lidar = np.fromfile(lidar_file, dtype=np.float32).reshape(-1, 4)
        if cfg.get('PERCENT_OF_PTS', 100) < 100:
            amount = int(len(lidar) * cfg.PERCENT_OF_PTS / 100)
            np.random.shuffle(lidar)
            lidar = lidar[:amount]
        return lidar

    def get_image_shape(self, idx):
        img_file = os.path.join(self.root_split_path, 'image_2', '%s.png' % idx)
        assert os.path.exists(img_file), img_file
        return png_shape(img_file)

    def get_colored_lidar(self, idx):
        """Points in the image and the RGB of their projection: (n, 6) [xyz,
        rgb] (TAG_PTS_WITH_RGB, `pcdet_tpu`'s `get_colored_lidar`).  The
        reference zeroes the colours it samples (`colors *= 0`), so the
        colours are zeros and only the image's shape is read."""
        lidar_file = os.path.join(self.root_split_path, 'velodyne',
                                  '%s.bin' % idx)
        assert os.path.exists(lidar_file), lidar_file
        pts = np.fromfile(lidar_file, dtype=np.float32).reshape(-1, 4)[:, :3]
        calib = self.get_calib(idx)
        pts_rect = calib.lidar_to_rect(pts)
        fov_flag = self.get_fov_flag(pts_rect, self.get_image_shape(idx),
                                     calib)
        pts_fov = pts[fov_flag]
        colors = np.zeros((len(pts_fov), 3), np.float32)
        return np.hstack([pts_fov, colors]).astype(np.float32)

    # BEV segmentation masks' crop (reference get_bev:164-203)
    BEV_CLASSES = ('DRIVABLE', 'VEHICLE')
    BEV_BOUNDS_M = (-50, 0, -25, 25)        # min x, max x, min y, max y
    BEV_METER_PER_PIXEL = 0.25

    def get_bev(self, idx):
        """BEV segmentation ground truth: (C, 200, 200) masks cropped to
        BEV_BOUNDS_M around each map's centre from
        training/bev_<class>/<idx>.png (the first channel of a colour
        map)."""
        pixel_bnds = (np.asarray(self.BEV_BOUNDS_M)
                      / self.BEV_METER_PER_PIXEL).astype(np.int64)
        bevs = []
        for cls in self.BEV_CLASSES:
            bev_path = os.path.join(self.root_split_path, 'bev_%s' % cls,
                                    '%s.png' % idx)
            assert os.path.exists(bev_path), bev_path
            bev = read_png(bev_path)
            if bev.ndim == 3:
                bev = bev[..., 0]
            rows_center, cols_center = np.asarray(bev.shape[:2]) // 2
            top, bottom = (pixel_bnds[0] + rows_center,
                           pixel_bnds[1] + rows_center)
            left, right = (pixel_bnds[2] + cols_center,
                           pixel_bnds[3] + cols_center)
            bevs.append(bev[top:bottom, left:right])
        return np.array(bevs)

    def get_label(self, idx):
        label_file = os.path.join(self.root_split_path, 'label_2', '%s.txt' % idx)
        assert os.path.exists(label_file), label_file
        return get_objects_from_label(label_file)

    def get_calib(self, idx):
        calib_file = os.path.join(self.root_split_path, 'calib', '%s.txt' % idx)
        assert os.path.exists(calib_file), calib_file
        return Calibration(calib_file)

    def get_road_plane(self, idx):
        plane_file = os.path.join(self.root_split_path, 'planes', '%s.txt' % idx)
        if not os.path.exists(plane_file):
            return None
        with open(plane_file, 'r') as f:
            lines = f.readlines()
        plane = np.asarray([float(i) for i in lines[3].split()])
        if plane[1] > 0:            # normal should point up (camera -y)
            plane = -plane
        return plane / np.linalg.norm(plane[0:3])

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        """Points whose image projection lands inside the image."""
        pts_img, pts_rect_depth = calib.rect_to_img(pts_rect)
        val = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
               & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0]))
        return val & (pts_rect_depth >= 0)

    # ------------------------------------------------------------ info files
    def include_kitti_data(self, mode, logger):
        if logger is not None:
            logger.info('Loading KITTI dataset')
        for info_path in self.cfg.DATA_CONFIG[mode].INFO_PATH:
            info_path = os.path.join(self.cfg.ROOT_DIR, info_path)
            with open(info_path, 'rb') as f:
                self.kitti_infos.extend(pickle.load(f))
        if logger is not None:
            logger.info('Total samples for KITTI dataset: %d'
                        % len(self.kitti_infos))

    def dataset_init(self, logger):
        self.db_sampler = None
        aug_cfg = self.cfg.DATA_CONFIG.get('AUGMENTATION', None)
        if (self.training and aug_cfg is not None
                and aug_cfg.DB_SAMPLER.ENABLED):
            from ..augmentation.dbsampler import DataBaseSampler
            db_infos = {}
            for db_info_path in aug_cfg.DB_SAMPLER.DB_INFO_PATH:
                db_info_path = os.path.join(self.cfg.ROOT_DIR, db_info_path)
                with open(db_info_path, 'rb') as f:
                    infos = pickle.load(f)
                if not db_infos:
                    db_infos = infos
                else:
                    for cls in db_infos:
                        db_infos[cls].extend(infos.get(cls, []))
            self.db_sampler = DataBaseSampler(
                db_infos=db_infos, sampler_cfg=aug_cfg.DB_SAMPLER,
                class_names=self.class_names, logger=logger)

    def get_infos(self, num_workers=4, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        """Per-frame metadata dicts (reference get_infos:255-362)."""
        import concurrent.futures as futures

        def process_single_scene(sample_idx):
            info = {'point_cloud': {'num_features': 4, 'lidar_idx': sample_idx},
                    'image': {'image_idx': sample_idx,
                              'image_shape': self.get_image_shape(sample_idx)}}
            calib = self.get_calib(sample_idx)
            p2 = np.concatenate([calib.P2, np.array([[0., 0., 0., 1.]])], axis=0)
            r0 = np.zeros((4, 4), dtype=calib.R0.dtype)
            r0[3, 3] = 1.
            r0[:3, :3] = calib.R0
            v2c = np.concatenate([calib.V2C, np.array([[0., 0., 0., 1.]])],
                                 axis=0)
            info['calib'] = {'P2': p2, 'R0_rect': r0, 'Tr_velo_to_cam': v2c}

            if has_label:
                obj_list = self.get_label(sample_idx)
                annotations = {
                    'name': np.array([o.cls_type for o in obj_list]),
                    'truncated': np.array([o.truncation for o in obj_list]),
                    'occluded': np.array([o.occlusion for o in obj_list]),
                    'alpha': np.array([o.alpha for o in obj_list]),
                    'bbox': np.array([o.box2d for o in obj_list]).reshape(-1, 4),
                    'dimensions': np.array([[o.l, o.h, o.w] for o in obj_list]
                                           ).reshape(-1, 3),
                    'location': np.array([o.loc for o in obj_list]).reshape(-1, 3),
                    'rotation_y': np.array([o.ry for o in obj_list]),
                    'score': np.array([o.score for o in obj_list]),
                    'difficulty': np.array([o.level for o in obj_list], np.int32),
                }
                num_objects = len([o for o in obj_list
                                   if o.cls_type != 'DontCare'])
                num_gt = len(annotations['name'])
                annotations['index'] = np.array(
                    list(range(num_objects)) + [-1] * (num_gt - num_objects),
                    dtype=np.int32)

                loc = annotations['location'][:num_objects]
                dims = annotations['dimensions'][:num_objects]
                rots = annotations['rotation_y'][:num_objects]
                loc_lidar = calib.rect_to_lidar(loc)
                l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
                gt_boxes_lidar = np.concatenate(
                    [loc_lidar, w, l, h, rots[..., np.newaxis]], axis=1)
                annotations['gt_boxes_lidar'] = gt_boxes_lidar
                info['annos'] = annotations

                if count_inside_pts:
                    points = self.get_lidar(sample_idx)
                    pts_rect = calib.lidar_to_rect(points[:, 0:3])
                    fov_flag = self.get_fov_flag(
                        pts_rect, info['image']['image_shape'], calib)
                    pts_fov = points[fov_flag]
                    masks = box_np_ops.points_in_boxes_mask(pts_fov,
                                                            gt_boxes_lidar)
                    num_points_in_gt = -np.ones(num_gt, dtype=np.int32)
                    num_points_in_gt[:num_objects] = masks.sum(axis=1)
                    annotations['num_points_in_gt'] = num_points_in_gt
            return info

        sample_id_list = sample_id_list or self.sample_id_list
        with futures.ThreadPoolExecutor(num_workers) as executor:
            infos = executor.map(process_single_scene, sample_id_list)
        return list(infos)

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split='train'):
        """Crop per-object point clouds into data/gt_database + dbinfos pkl
        (reference create_groundtruth_database:364-440)."""
        database_save_path = Path(self.root_path) / (
            'gt_database' if split == 'train' else 'gt_database_%s' % split)
        db_info_save_path = Path(self.root_path) / (
            'kitti_dbinfos_%s.pkl' % split)
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}

        with open(info_path, 'rb') as f:
            infos = pickle.load(f)

        for k, info in enumerate(infos):
            sample_idx = info['point_cloud']['lidar_idx']
            points = self.get_lidar(sample_idx)
            annos = info['annos']
            gt_boxes = annos['gt_boxes_lidar']
            num_obj = gt_boxes.shape[0]
            masks = box_np_ops.points_in_boxes_mask(points, gt_boxes)  # (N, P)

            for i in range(num_obj):
                filename = '%s_%s_%d.bin' % (sample_idx, annos['name'][i], i)
                filepath = database_save_path / filename
                gt_points = points[masks[i]]
                gt_points[:, :3] -= gt_boxes[i, :3]
                gt_points.astype(np.float32).tofile(str(filepath))

                if used_classes is None or annos['name'][i] in used_classes:
                    db_path = str(filepath.relative_to(self.root_path))
                    db_info = {'name': annos['name'][i], 'path': db_path,
                               'image_idx': sample_idx, 'gt_idx': i,
                               'box3d_lidar': gt_boxes[i],
                               'num_points_in_gt': gt_points.shape[0],
                               'difficulty': annos['difficulty'][i],
                               'bbox': annos['bbox'][i],
                               'score': annos['score'][i]}
                    all_db_infos.setdefault(annos['name'][i], []).append(db_info)

        for k, v in all_db_infos.items():
            print('Database %s: %d' % (k, len(v)))
        with open(db_info_save_path, 'wb') as f:
            pickle.dump(all_db_infos, f)

    # ------------------------------------------------------------- iteration
    def __len__(self):
        return len(self.kitti_infos)

    def __getitem__(self, index):
        cfg = self.cfg
        info = copy.deepcopy(self.kitti_infos[index])
        sample_idx = info['point_cloud']['lidar_idx']
        if cfg.get('TAG_PTS_WITH_RGB', False):
            # colored-lidar point painting (reference :707-708)
            points = self.get_colored_lidar(sample_idx)
        else:
            points = self.get_lidar(sample_idx)
        calib = self.get_calib(sample_idx)
        img_shape = info['image']['image_shape']

        if cfg.DATA_CONFIG.FOV_POINTS_ONLY:
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            fov_flag = self.get_fov_flag(pts_rect, img_shape, calib)
            points = points[fov_flag]

        input_dict = {'points': points, 'sample_idx': sample_idx,
                      'calib': calib}

        if 'annos' in info:
            annos = common.drop_info_with_name(info['annos'], name='DontCare')
            loc, dims, rots = (annos['location'], annos['dimensions'],
                               annos['rotation_y'])
            gt_names = annos['name']
            gt_boxes_cam = np.concatenate(
                [loc, dims, rots[..., np.newaxis]], axis=1).astype(np.float32)
            if 'gt_boxes_lidar' in annos:
                gt_boxes_lidar = annos['gt_boxes_lidar']
            else:
                gt_boxes_lidar = box_np_ops.boxes3d_camera_to_lidar(
                    gt_boxes_cam, calib)
            input_dict.update({'gt_names': gt_names,
                               'gt_boxes_lidar': gt_boxes_lidar})

        if cfg.get('TAG_PTS_IF_IN_GT_BBOXES', False) and 'annos' in info:
            points = input_dict['points']
            points[:, 3] = 0
            masks = box_np_ops.points_in_boxes_mask(
                points, input_dict['gt_boxes_lidar'])
            for k in range(len(input_dict['gt_boxes_lidar'])):
                if input_dict['gt_names'][k] == 'Car':
                    points[masks[k], 3] = 1
            input_dict['points'] = points

        example = self.prepare_data(input_dict=input_dict,
                                    has_label='annos' in info,
                                    rng=self.sample_rng(index))
        example['sample_idx'] = sample_idx
        example['image_shape'] = np.asarray(img_shape, dtype=np.int32)
        if 'bev' in cfg.get('MODE', ''):
            # BEV-seg GT masks ride the batch (reference :759-761)
            bev = self.get_bev(sample_idx).transpose(1, 2, 0)
            example['bev'] = (bev > 0).astype(np.float32)
        return example

    # -------------------------------------------------------------- eval glue
    def _calib_for(self, sample_idx):
        ci = self._info_by_idx[str(sample_idx)]['calib']
        return Calibration({'P2': ci['P2'][:3], 'R0': ci['R0_rect'][:3, :3],
                            'Tr_velo2cam': ci['Tr_velo_to_cam'][:3]})

    def generate_annotations(self, batch, preds, class_names,
                             save_to_file=False, output_dir=None):
        """Fixed-shape predictions -> list of KITTI anno dicts.

        Combines the reference's generate_prediction_dict (kitti_dataset.py:
        442-483: lidar->camera->image mapping) and generate_annotations
        (:485-600: image-area + range filters, KITTI txt emission); `preds`
        are host arrays.
        """
        cfg = self.cfg
        annos = []
        batch_size = batch['batch_size']
        for i in range(batch_size):
            sample_idx = batch['sample_idx'][i]
            valid = preds['valid'][i]
            boxes_lidar = preds['boxes'][i][valid]
            scores = preds['scores'][i][valid]
            labels = preds['labels'][i][valid]
            image_shape = batch['image_shape'][i] if 'image_shape' in batch \
                else None

            anno = _empty_anno()
            if boxes_lidar.shape[0] > 0:
                calib = self._calib_for(sample_idx)
                boxes_cam = box_np_ops.boxes3d_lidar_to_camera(boxes_lidar,
                                                               calib)
                boxes_img = box_np_ops.boxes3d_camera_to_imageboxes(
                    boxes_cam, calib, image_shape=None)

                keep_rows = []
                box_filter = cfg.MODEL.TEST.BOX_FILTER
                for j in range(boxes_lidar.shape[0]):
                    bbox = boxes_img[j]
                    if box_filter['USE_IMAGE_AREA_FILTER'] \
                            and image_shape is not None:
                        area_limit = image_shape[0] * image_shape[1] * 0.8
                        if (bbox[0] > image_shape[1] or bbox[1] > image_shape[0]
                                or bbox[2] < 0 or bbox[3] < 0):
                            continue
                        bbox[2:] = np.minimum(bbox[2:], image_shape[::-1])
                        bbox[:2] = np.maximum(bbox[:2], [0, 0])
                        if (bbox[2] - bbox[0]) * (bbox[3] - bbox[1]) > area_limit:
                            continue
                    if 'LIMIT_RANGE' in box_filter:
                        lr = np.array(box_filter['LIMIT_RANGE'])
                        if (np.any(boxes_lidar[j, :3] < lr[:3])
                                or np.any(boxes_lidar[j, :3] > lr[3:])):
                            continue
                    if not np.all(boxes_lidar[j, 3:6] > -0.1):
                        continue
                    keep_rows.append(j)

                if keep_rows:
                    keep_rows = np.asarray(keep_rows)
                    bl = boxes_lidar[keep_rows]
                    bc = boxes_cam[keep_rows]
                    bi = boxes_img[keep_rows]
                    sc = scores[keep_rows]
                    lb = labels[keep_rows]
                    anno = {
                        'name': np.array([class_names[int(l) - 1] for l in lb]),
                        'truncated': np.zeros(len(keep_rows)),
                        'occluded': np.zeros(len(keep_rows), dtype=np.int64),
                        'alpha': (-np.arctan2(-bl[:, 1], bl[:, 0]) + bc[:, 6]),
                        'bbox': bi,
                        'dimensions': bc[:, 3:6],
                        'location': bc[:, :3],
                        'rotation_y': bc[:, 6],
                        'score': sc,
                        'boxes_lidar': bl,
                    }
            num_example = len(anno['name'])
            anno['num_example'] = num_example
            anno['sample_idx'] = np.array([sample_idx] * num_example)
            annos.append(anno)

            if save_to_file and output_dir is not None:
                os.makedirs(output_dir, exist_ok=True)
                cur_det_file = os.path.join(output_dir, '%s.txt' % sample_idx)
                with open(cur_det_file, 'w') as f:
                    for idx in range(num_example):
                        bbox = anno['bbox'][idx]
                        loc = anno['location'][idx]
                        dims = anno['dimensions'][idx]
                        print('%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
                              '%.4f %.4f %.4f %.4f %.4f %.4f'
                              % (anno['name'][idx], anno['alpha'][idx],
                                 bbox[0], bbox[1], bbox[2], bbox[3],
                                 dims[1], dims[2], dims[0],
                                 loc[0], loc[1], loc[2],
                                 anno['rotation_y'][idx], anno['score'][idx]),
                              file=f)
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        if 'annos' not in self.kitti_infos[0]:
            return 'None', {}
        from .kitti_eval import eval as kitti_eval
        eval_det = copy.deepcopy(det_annos)
        eval_gt = [copy.deepcopy(info['annos']) for info in self.kitti_infos]
        return kitti_eval.get_official_eval_result(eval_gt, eval_det,
                                                   class_names)


def _empty_anno():
    return {'name': np.array([]), 'truncated': np.array([]),
            'occluded': np.array([]), 'alpha': np.array([]),
            'bbox': np.zeros([0, 4]), 'dimensions': np.zeros([0, 3]),
            'location': np.zeros([0, 3]), 'rotation_y': np.array([]),
            'score': np.array([]), 'boxes_lidar': np.zeros([0, 7])}


def create_kitti_infos(cfg, data_path=None, save_path=None, workers=4):
    """Generate kitti_infos_{train,val,trainval,test}.pkl + gt database
    (reference create_kitti_infos:801-838)."""
    data_path = data_path or os.path.join(cfg.ROOT_DIR, cfg.DATA_CONFIG.DATA_DIR)
    save_path = save_path or data_path

    dataset = KittiDataset(cfg, training=False, split='train',
                           root_path=data_path, for_info_generation=True)
    train_split, val_split = 'train', 'val'

    out = {}
    for split in [train_split, val_split]:
        dataset.set_split(split)
        infos = dataset.get_infos(num_workers=workers, has_label=True,
                                  count_inside_pts=True)
        path = os.path.join(save_path, 'kitti_infos_%s.pkl' % split)
        with open(path, 'wb') as f:
            pickle.dump(infos, f)
        out[split] = infos
        print('Kitti info %s file is saved to %s' % (split, path))

    with open(os.path.join(save_path, 'kitti_infos_trainval.pkl'), 'wb') as f:
        pickle.dump(out[train_split] + out[val_split], f)

    dataset.set_split('test')
    if dataset.sample_id_list:
        infos_test = dataset.get_infos(num_workers=workers, has_label=False,
                                       count_inside_pts=False)
        with open(os.path.join(save_path, 'kitti_infos_test.pkl'), 'wb') as f:
            pickle.dump(infos_test, f)

    print('--------------- Start create groundtruth database ---------------')
    dataset.set_split(train_split)
    dataset.create_groundtruth_database(
        info_path=os.path.join(save_path, 'kitti_infos_train.pkl'),
        split=train_split)
    print('---------------- Data preparation Done ----------------')
