"""Convert Argoverse / nuScenes raw data into a KITTI-format tree.

The port's twin of `tools/convert_to_kitti.py` (the reference fork trains on
externally produced "*-kitti-format" trees with pinned splits, reference
argoverse-splits.py and nuscenes-splits.py; here the conversion is a CLI):

    python -m pcdet_tpu_torch.tools.convert_to_kitti argoverse \
        --src /data/argoverse-tracking --dst data/argo
    python -m pcdet_tpu_torch.tools.convert_to_kitti nuscenes \
        --src /data/nuscenes --version v1.0-trainval --dst data/nuscenes

Then `python -m pcdet_tpu_torch.tools.create_data kitti --data_path DST`
builds the info and GT-database pickles.
"""
import argparse

from ..datasets.converters import argoverse, nuscenes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('dataset', choices=['argoverse', 'nuscenes'])
    ap.add_argument('--src', required=True, help='raw dataset root')
    ap.add_argument('--dst', required=True, help='KITTI-format output root')
    ap.add_argument('--splits_dir', default=None,
                    help='override the pinned split lists '
                         '(default: converters/splits/)')
    ap.add_argument('--every_n', type=int, default=1,
                    help='keep every n-th sweep')
    ap.add_argument('--max_frames', type=int, default=0,
                    help='cap frames per log/scene (0 = all)')
    ap.add_argument('--version', default='v1.0-trainval',
                    help='nuscenes table version')
    args = ap.parse_args(argv)

    if args.dataset == 'argoverse':
        return argoverse.convert(
            args.src, args.dst,
            splits_dir=args.splits_dir or argoverse.SPLITS_DIR,
            every_n=args.every_n, max_frames_per_log=args.max_frames)
    return nuscenes.convert(
        args.src, args.dst, version=args.version,
        splits_dir=args.splits_dir or nuscenes.SPLITS_DIR,
        every_n=args.every_n, max_frames_per_scene=args.max_frames)


if __name__ == '__main__':
    main()
