"""Synthetic "boxes in a box" LiDAR scenes (numpy).

The port's copy of `pcdet_tpu.datasets.synthetic.make_scene` and what it
calls: cars, pedestrians and cyclists as point-sprinkled cuboid shells on
uniform or beam-structured ground.  The same RandomState gives the same
scene in both packages.
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
    ground plane on a ring of radius h / tan(|elev|), so the returns are
    dense along rings, as in real scans."""
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
    """Random scene: returns points (P, 4), gt_boxes (M, 7), gt_names (M,).

    :param ground_mode: 'uniform' scatters `num_ground` points in a z band;
        'rings' makes beam-structured ground (`lidar_ground_rings`;
        `num_ground` is ignored)
    :param ring_keep: fraction of ring returns kept (rings mode); about
        0.35 gives the ~17-20k points of a FOV-cropped KITTI scan
    """
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
        # points pushed to the box's faces, as LiDAR returns from shells
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
