"""Argoverse 3D tracking -> KITTI-format converter: the port's copy of
`pcdet_tpu.datasets.converters.argoverse`.

Replaces the reference fork's external "argoverse-tracking-kitti-format"
export (the fork pins only its 65 / 24 train / val log ids, reference
argoverse-splits.py:1-96).  Reads the raw argoverse-tracking layout
directly (binary PLY sweeps, per-sweep amodal annotation JSONs), with no
argoverse-api dependency:

    <src>/<any subdir>/<log_id>/
        lidar/PC_<timestamp>.ply                       (ego-frame points)
        per_sweep_annotations_amodal/
            tracked_object_labels_<timestamp>.json     (ego-frame boxes)
        vehicle_calibration_info.json                  (optional intrinsics)

Sample ids follow the fork's '%03d%06d' % (log_index, frame_index) scheme
(`datasets.splits.kitti_style_sample_ids`); log_index is the position in
the combined train + val pinned list, so ids are unique across splits.
"""
import glob
import json
import os
import struct

import numpy as np

from .kitti_writer import KittiWriter

SPLITS_DIR = os.path.join(os.path.dirname(__file__), 'splits')

# argoverse label_class -> KITTI class
CLASS_MAP = {
    'VEHICLE': 'Car',
    'PEDESTRIAN': 'Pedestrian',
    'BICYCLIST': 'Cyclist',
    'BICYCLE': 'Cyclist',
    'LARGE_VEHICLE': 'Truck',
    'BUS': 'Truck',
    'TRAILER': 'Truck',
    'MOTORCYCLIST': 'Cyclist',
}

_PLY_TYPES = {
    'char': 'b', 'int8': 'b', 'uchar': 'B', 'uint8': 'B',
    'short': 'h', 'int16': 'h', 'ushort': 'H', 'uint16': 'H',
    'int': 'i', 'int32': 'i', 'uint': 'I', 'uint32': 'I',
    'float': 'f', 'float32': 'f', 'double': 'd', 'float64': 'd',
}


def read_ply_points(path):
    """Minimal binary/ascii PLY vertex reader -> (N, 4) [x, y, z, intensity].

    Handles the little-endian binary PLYs argoverse ships (x/y/z double or
    float + intensity/laser_number integer extras); intensity is normalised
    to [0, 1] when stored as an integer type.
    """
    with open(path, 'rb') as f:
        if f.readline().strip() != b'ply':
            raise ValueError('not a PLY file: %s' % path)
        fmt = None
        n_vertex = None
        props = []          # (name, struct char) for the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError('unterminated PLY header: %s' % path)
            parts = line.decode('ascii', 'replace').strip().split()
            if not parts:
                continue
            if parts[0] == 'format':
                fmt = parts[1]
            elif parts[0] == 'element':
                in_vertex = parts[1] == 'vertex'
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == 'property' and in_vertex:
                if parts[1] == 'list':
                    raise ValueError('list property in vertex element')
                props.append((parts[2], _PLY_TYPES[parts[1]]))
            elif parts[0] == 'end_header':
                break
        if fmt == 'ascii':
            rows = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex)
            rows = rows.reshape(n_vertex, len(props))
            cols = {name: rows[:, i] for i, (name, _) in enumerate(props)}
            int_intensity = False
        else:
            if fmt != 'binary_little_endian':
                raise ValueError('unsupported PLY format: %s' % fmt)
            rec = np.dtype([(name, '<' + ch) for name, ch in props])
            rows = np.frombuffer(f.read(rec.itemsize * n_vertex), dtype=rec,
                                 count=n_vertex)
            cols = {name: rows[name].astype(np.float64)
                    for name, _ in props}
            int_intensity = any(name == 'intensity' and ch in 'BbHhIi'
                                for name, ch in props)
    xyz = np.stack([cols['x'], cols['y'], cols['z']], axis=1)
    if 'intensity' in cols:
        inten = cols['intensity']
        if int_intensity or inten.max(initial=0.0) > 1.0:
            inten = inten / 255.0
    else:
        inten = np.zeros(len(xyz))
    return np.concatenate([xyz, inten[:, None]], axis=1).astype(np.float32)


def quat_to_yaw(w, x, y, z):
    return float(np.arctan2(2.0 * (w * z + x * y),
                            1.0 - 2.0 * (y * y + z * z)))


def load_pinned_splits(splits_dir=SPLITS_DIR):
    def read(name):
        with open(os.path.join(splits_dir, name)) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return read('argoverse_train_logs.txt'), read('argoverse_val_logs.txt')


def find_log_dir(src, log_id):
    """Logs live under split subdirs (train1..4/val/test) or directly."""
    direct = os.path.join(src, log_id)
    if os.path.isdir(direct):
        return direct
    hits = glob.glob(os.path.join(src, '*', log_id))
    return hits[0] if hits else None


def log_timestamps(log_dir):
    files = sorted(glob.glob(os.path.join(log_dir, 'lidar', 'PC_*.ply')))
    return [os.path.basename(p)[3:-4] for p in files]


def load_annotations(log_dir, ts):
    path = os.path.join(log_dir, 'per_sweep_annotations_amodal',
                        'tracked_object_labels_%s.json' % ts)
    if not os.path.exists(path):
        return np.zeros((0, 7), np.float32), []
    with open(path) as f:
        objs = json.load(f)
    boxes, names = [], []
    for o in objs:
        cls = CLASS_MAP.get(o.get('label_class', ''), None)
        if cls is None:
            continue
        c = o['center']
        q = o['rotation']
        yaw = quat_to_yaw(q['w'], q['x'], q['y'], q['z'])
        # argoverse: length along the object x-axis (heading); this repo's
        # lidar boxes put the heading on local +y, so ry = pi/2 - yaw
        boxes.append([c['x'], c['y'], c['z'] - o['height'] / 2.0,
                      o['width'], o['length'], o['height'],
                      np.pi / 2.0 - yaw])
        names.append(cls)
    return np.asarray(boxes, np.float32).reshape(-1, 7), names


def camera_params(log_dir, camera='ring_front_center'):
    """(image_shape, P2) from vehicle_calibration_info.json, or defaults."""
    path = os.path.join(log_dir, 'vehicle_calibration_info.json')
    default = ((1200, 1920), None)
    if not os.path.exists(path):
        return default
    try:
        with open(path) as f:
            info = json.load(f)
        for cam in info.get('camera_data_', []):
            if camera in cam.get('key', ''):
                v = cam['value']
                fu = float(v['focal_length_x_px_'])
                fv = float(v['focal_length_y_px_'])
                cu = float(v['focal_center_x_px_'])
                cv = float(v['focal_center_y_px_'])
                from .kitti_writer import make_p2
                return (1200, 1920), make_p2(fu, fv, cu, cv)
    except (KeyError, ValueError, json.JSONDecodeError):
        pass
    return default


def convert(src, dst, splits_dir=SPLITS_DIR, every_n=1, max_frames_per_log=0,
            logger=print):
    """Convert the pinned train+val argoverse logs under `src` into a
    KITTI-format tree at `dst`.  Missing logs are skipped with a warning (so
    a partial download still converts)."""
    train_logs, val_logs = load_pinned_splits(splits_dir)
    all_logs = [(lg, 'train') for lg in train_logs] + \
               [(lg, 'val') for lg in val_logs]

    writer = None
    n_missing = 0
    for li, (log_id, split) in enumerate(all_logs):
        log_dir = find_log_dir(src, log_id)
        if log_dir is None:
            n_missing += 1
            continue
        if writer is None:
            image_shape, p2 = camera_params(log_dir)
            # argoverse ego frame sits on the ground -> camera height ~0
            writer = KittiWriter(dst, image_shape=image_shape, p2=p2,
                                 ground_plane_d=0.0)
        ts_list = log_timestamps(log_dir)[::max(1, every_n)]
        if max_frames_per_log:
            ts_list = ts_list[:max_frames_per_log]
        for fi, ts in enumerate(ts_list):
            points = read_ply_points(
                os.path.join(log_dir, 'lidar', 'PC_%s.ply' % ts))
            boxes, names = load_annotations(log_dir, ts)
            sid = '%03d%06d' % (li, fi)
            writer.write_frame(sid, split, points, boxes, names)
        logger('[argoverse] %s (%s): %d frames' % (log_id, split, len(ts_list)))
    if writer is None:
        raise FileNotFoundError('no pinned argoverse logs found under %s' % src)
    counts = writer.finalize()
    if n_missing:
        logger('[argoverse] WARNING: %d pinned logs missing under %s'
               % (n_missing, src))
    logger('[argoverse] wrote %s: %s' % (dst, counts))
    return counts
