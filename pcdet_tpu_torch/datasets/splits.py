"""Split files of the KITTI-format conversions (Argoverse / nuScenes): the
port's copy of `pcdet_tpu.datasets.splits`.

The reference fork pins its Argoverse / nuScenes train / val splits as
hardcoded log-id lists (`argoverse-splits.py`, `nuscenes-splits.py`).  Here
a split is a FILE (one log / scene id per line, like KITTI's
ImageSets/*.txt), so splits are data, not code:

    data/<dataset>/ImageSets/{train,val}_logs.txt

`write_split_files` writes a split once; the converters read it with
`load_split`.
"""
import os


def load_split(split_dir, split):
    """Read `<split>_logs.txt` -> list of log/scene ids."""
    path = os.path.join(split_dir, '%s_logs.txt' % split)
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def write_split_files(split_dir, train_logs, val_logs):
    os.makedirs(split_dir, exist_ok=True)
    for name, logs in [('train', train_logs), ('val', val_logs)]:
        with open(os.path.join(split_dir, '%s_logs.txt' % name), 'w') as f:
            f.write('\n'.join(logs) + '\n')


def kitti_style_sample_ids(log_ids, frames_per_log):
    """Map (log, frame) pairs to KITTI-style zero-padded sample ids, the
    scheme the fork's converters use for Argoverse->KITTI conversion."""
    ids = []
    for li, log in enumerate(log_ids):
        for fi in range(frames_per_log.get(log, 0)):
            ids.append('%03d%06d' % (li, fi))
    return ids
