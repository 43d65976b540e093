# Frozen copy of pcdet_tpu_torch/datasets/synthetic.py:20-122 (SIZES,
# lidar_ground_rings, make_scene) at the commit that added this benchmark;
# the pool builder below is the benchmark's own.
"""Synthetic KITTI-density LiDAR scans for the benchmark's traffic.

`make_scene` is the port's generator, copied so that a later change to the
program cannot move the benchmark's inputs.  `make_pool` draws the scene
ids of a run from its seed and pads every scan to a fixed point count, as
`pcdet_tpu_torch.detect.make_scans` does (scene i from RandomState(i)).
"""
import numpy as np

# class -> (w, l, h) mean sizes
SIZES = {
    'Car': (1.6, 3.9, 1.56),
    'Pedestrian': (0.6, 0.8, 1.73),
    'Cyclist': (0.6, 1.76, 1.73),
}


def lidar_ground_rings(rng, num_beams=64, elev_range=(-24.9, -0.5),
                       azim_range=(-48.0, 48.0), azim_step=0.17,
                       ground_z=-1.73, max_range=70.0, noise=0.02):
    """Ground returns of a spinning LiDAR: each downward beam meets the
    ground plane on a ring of radius h / tan(|elev|)."""
    elevs = np.radians(np.linspace(elev_range[0], elev_range[1], num_beams))
    azims = np.radians(np.arange(azim_range[0], azim_range[1], azim_step))
    pts = []
    sensor_h = -ground_z
    for el in elevs:
        if el >= -1e-3:
            continue
        r = sensor_h / np.tan(-el)
        if r > max_range:
            continue
        ring_az = azims + rng.uniform(-1e-3, 1e-3)
        x = r * np.cos(ring_az)
        y = r * np.sin(ring_az)
        n = len(ring_az)
        pts.append(np.stack([
            x + rng.normal(0, noise, n), y + rng.normal(0, noise, n),
            np.full(n, ground_z) + rng.normal(0, noise, n),
            rng.uniform(0, 1, n)], axis=1))
    if not pts:
        return np.zeros((0, 4), np.float32)
    return np.concatenate(pts).astype(np.float32)


def make_scene(rng, class_names, num_objects=8, num_ground=4000,
               pts_per_obj=300, x_range=(5, 60), y_range=(-30, 30),
               ground_mode='uniform', ring_keep=1.0):
    """Random scene: points (P, 4), gt_boxes (M, 7), gt_names (M,)."""
    boxes, names = [], []
    for _ in range(num_objects):
        cls = class_names[rng.randint(len(class_names))]
        w, l, h = SIZES[cls]
        scale = rng.uniform(0.9, 1.1)
        w, l, h = w * scale, l * scale, h * scale
        x = rng.uniform(*x_range)
        y = rng.uniform(*y_range)
        z = rng.uniform(-1.8, -1.4)
        ry = rng.uniform(-np.pi, np.pi)
        boxes.append([x, y, z, w, l, h, ry])
        names.append(cls)
    boxes = np.asarray(boxes, dtype=np.float32).reshape(-1, 7)
    names = np.asarray(names)

    pts = []
    for b in boxes:
        x, y, z, w, l, h, ry = b
        local = np.stack([
            rng.uniform(-w / 2, w / 2, pts_per_obj),
            rng.uniform(-l / 2, l / 2, pts_per_obj),
            rng.uniform(0, h, pts_per_obj),
        ], axis=1)
        face = rng.randint(0, 3, pts_per_obj)
        sign = rng.randint(0, 2, pts_per_obj) * 2 - 1
        local[face == 0, 0] = (w / 2) * sign[face == 0]
        local[face == 1, 1] = (l / 2) * sign[face == 1]
        local[face == 2, 2] = (h / 2) * (sign[face == 2] * 0.5 + 0.5) * 2
        c, s = np.cos(ry), np.sin(ry)
        gx = local[:, 0] * c + local[:, 1] * s + x
        gy = -local[:, 0] * s + local[:, 1] * c + y
        gz = local[:, 2] + z
        refl = rng.uniform(0, 1, pts_per_obj)
        pts.append(np.stack([gx, gy, gz, refl], axis=1))

    if ground_mode == 'rings':
        rings = lidar_ground_rings(rng)
        if ring_keep < 1.0:
            keep = rng.uniform(size=len(rings)) < ring_keep
            rings = rings[keep]
        pts.append(rings)
    else:
        ground = np.stack([
            rng.uniform(0, 69, num_ground),
            rng.uniform(-39, 39, num_ground),
            rng.normal(-1.75, 0.05, num_ground),
            rng.uniform(0, 1, num_ground),
        ], axis=1)
        pts.append(ground)
    points = np.concatenate(pts, axis=0).astype(np.float32)
    return points, boxes, names


def scene_ids(seed, count, stream):
    """`count` distinct scene ids drawn from the run's seed; `stream` keeps
    the draws of different uses (the pool, the BN calibration) apart."""
    rng = np.random.default_rng([int(seed), int(stream)])
    return rng.choice(2 ** 31 - 1, size=count, replace=False)


def make_pool(ids, class_names, scene, max_points, max_gt):
    """Scans of `ids` as the program takes them: points (N, P, 4) f32,
    mask (N, P) bool, gt_boxes (N, max_gt, 8) f32 with class ids 1..C.

    :param scene: the traffic file's scene parameters (`make_scene`'s
        keyword arguments)
    """
    names = list(class_names)
    n = len(ids)
    points = np.zeros((n, max_points, 4), np.float32)
    mask = np.zeros((n, max_points), bool)
    gt = np.zeros((n, max_gt, 8), np.float32)
    for i, sid in enumerate(ids):
        pts, boxes, box_names = make_scene(
            np.random.RandomState(int(sid)), names,
            num_objects=int(scene['num_objects']), ground_mode='rings',
            pts_per_obj=int(scene['pts_per_obj']),
            x_range=tuple(scene['x_range']), y_range=tuple(scene['y_range']),
            ring_keep=float(scene['ring_keep']))
        k = min(len(pts), max_points)
        points[i, :k] = pts[:k]
        mask[i, :k] = True
        m = min(len(boxes), max_gt)
        gt[i, :m, :7] = boxes[:m]
        gt[i, :m, 7] = [names.index(x) + 1 for x in box_names[:m]]
    return points, mask, gt
