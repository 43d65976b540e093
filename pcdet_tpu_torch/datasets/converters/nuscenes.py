"""nuScenes -> KITTI-format converter: the port's copy of
`pcdet_tpu.datasets.converters.nuscenes`.

Reads the raw nuScenes relational tables directly (no nuscenes-devkit
dependency):

    <src>/<version>/{scene,sample,sample_data,ego_pose,calibrated_sensor,
                     sensor,sample_annotation,instance,category}.json
    <src>/samples/LIDAR_TOP/*.pcd.bin     (float32 x y z intensity ring)

For every key-frame LIDAR_TOP sweep of the pinned scenes (reference
nuscenes-splits.py:1-173 -> converters/splits/nuscenes_*.txt) the
global-frame annotations are mapped into the lidar frame through
ego_pose^-1 then calibrated_sensor^-1 and written as KITTI label / calib /
bin files that `datasets.kitti.kitti_dataset.KittiDataset` reads.
"""
import json
import os

import numpy as np

from .kitti_writer import KittiWriter

SPLITS_DIR = os.path.join(os.path.dirname(__file__), 'splits')

CLASS_MAP = {
    'vehicle.car': 'Car',
    'human.pedestrian.adult': 'Pedestrian',
    'human.pedestrian.child': 'Pedestrian',
    'human.pedestrian.construction_worker': 'Pedestrian',
    'human.pedestrian.police_officer': 'Pedestrian',
    'vehicle.bicycle': 'Cyclist',
    'vehicle.truck': 'Truck',
    'vehicle.bus.bendy': 'Truck',
    'vehicle.bus.rigid': 'Truck',
    'vehicle.trailer': 'Truck',
    'vehicle.construction': 'Truck',
}


def quat_to_rot(q):
    """nuScenes [w, x, y, z] quaternion -> (3, 3) rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def load_pinned_splits(splits_dir=SPLITS_DIR):
    def read(name):
        with open(os.path.join(splits_dir, name)) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return (read('nuscenes_train_scenes.txt'),
            read('nuscenes_val_scenes.txt'))


class Tables:
    """Token-indexed nuScenes tables."""

    def __init__(self, src, version):
        self.src = src
        tdir = os.path.join(src, version)
        self.by_token = {}
        for name in ['scene', 'sample', 'sample_data', 'ego_pose',
                     'calibrated_sensor', 'sensor', 'sample_annotation',
                     'instance', 'category']:
            with open(os.path.join(tdir, name + '.json')) as f:
                rows = json.load(f)
            self.by_token[name] = {r['token']: r for r in rows}
        self.scenes_by_name = {r['name']: r
                               for r in self.by_token['scene'].values()}
        # per-sample LIDAR_TOP key frames
        self.lidar_by_sample = {}
        for sd in self.by_token['sample_data'].values():
            if not sd.get('is_key_frame', False):
                continue
            cs = self.by_token['calibrated_sensor'][
                sd['calibrated_sensor_token']]
            sensor = self.by_token['sensor'][cs['sensor_token']]
            if sensor['channel'] == 'LIDAR_TOP':
                self.lidar_by_sample[sd['sample_token']] = sd
        # annotations per sample
        self.annos_by_sample = {}
        for a in self.by_token['sample_annotation'].values():
            self.annos_by_sample.setdefault(a['sample_token'], []).append(a)

    def scene_samples(self, scene):
        out = []
        tok = scene['first_sample_token']
        while tok:
            s = self.by_token['sample'][tok]
            out.append(s)
            tok = s['next']
        return out

    def category_name(self, anno):
        if 'category_name' in anno:
            return anno['category_name']
        inst = self.by_token['instance'][anno['instance_token']]
        return self.by_token['category'][inst['category_token']]['name']


def read_lidar_bin(path):
    """nuScenes .pcd.bin: float32 [x, y, z, intensity, ring] per point."""
    raw = np.fromfile(path, dtype=np.float32)
    pts = raw.reshape(-1, 5)[:, :4].copy()
    if len(pts) and pts[:, 3].max() > 1.0:
        pts[:, 3] /= 255.0
    return pts


def annos_to_lidar_boxes(tables, annos, sd):
    """Global-frame annotations -> this repo's lidar boxes + names."""
    ego = tables.by_token['ego_pose'][sd['ego_pose_token']]
    cs = tables.by_token['calibrated_sensor'][sd['calibrated_sensor_token']]
    r_e = quat_to_rot(ego['rotation'])
    t_e = np.asarray(ego['translation'], np.float64)
    r_s = quat_to_rot(cs['rotation'])
    t_s = np.asarray(cs['translation'], np.float64)

    boxes, names = [], []
    for a in annos:
        cls = CLASS_MAP.get(tables.category_name(a), None)
        if cls is None:
            continue
        c_g = np.asarray(a['translation'], np.float64)
        c_sensor = r_s.T @ (r_e.T @ (c_g - t_e) - t_s)
        r_total = r_s.T @ r_e.T @ quat_to_rot(a['rotation'])
        yaw = float(np.arctan2(r_total[1, 0], r_total[0, 0]))
        w, l, h = [float(v) for v in a['size']]
        boxes.append([c_sensor[0], c_sensor[1], c_sensor[2] - h / 2.0,
                      w, l, h, np.pi / 2.0 - yaw])
        names.append(cls)
    return np.asarray(boxes, np.float32).reshape(-1, 7), names


def convert(src, dst, version='v1.0-trainval', splits_dir=SPLITS_DIR,
            every_n=1, max_frames_per_scene=0, logger=print):
    train_scenes, val_scenes = load_pinned_splits(splits_dir)
    tables = Tables(src, version)
    all_scenes = [(s, 'train') for s in train_scenes] + \
                 [(s, 'val') for s in val_scenes]

    # nuScenes LIDAR_TOP sits ~1.84 m above the road
    writer = KittiWriter(dst, image_shape=(900, 1600), ground_plane_d=1.84)
    n_missing = 0
    for si, (scene_name, split) in enumerate(all_scenes):
        scene = tables.scenes_by_name.get(scene_name)
        if scene is None:
            n_missing += 1
            continue
        samples = tables.scene_samples(scene)[::max(1, every_n)]
        if max_frames_per_scene:
            samples = samples[:max_frames_per_scene]
        n_written = 0
        for fi, sample in enumerate(samples):
            sd = tables.lidar_by_sample.get(sample['token'])
            if sd is None:
                continue
            lidar_path = os.path.join(src, sd['filename'])
            if not os.path.exists(lidar_path):
                continue
            points = read_lidar_bin(lidar_path)
            boxes, names = annos_to_lidar_boxes(
                tables, tables.annos_by_sample.get(sample['token'], []), sd)
            sid = '%04d%05d' % (si, fi)
            writer.write_frame(sid, split, points, boxes, names)
            n_written += 1
        logger('[nuscenes] %s (%s): %d frames' % (scene_name, split, n_written))
    counts = writer.finalize()
    if n_missing:
        logger('[nuscenes] WARNING: %d pinned scenes absent in %s'
               % (n_missing, version))
    logger('[nuscenes] wrote %s: %s' % (dst, counts))
    return counts
