"""Dataset preprocessing: the info pickles and the GT database of a
KITTI-format tree.

The port's counterpart of `tools/create_data.py` (the reference's
`create_kitti_infos` entry, kitti_dataset.py:801-838):

    python -m pcdet_tpu_torch.tools.create_data kitti \
        --cfg_file tools/cfgs/pointpillar.yaml [--data_path DIR]

writes kitti_infos_{train,val,trainval}.pkl (and _test where
ImageSets/test.txt lists frames), gt_database/ and
kitti_dbinfos_train.pkl into `--save_path` (default: the tree).
"""
import argparse

from ..config import cfg_from_yaml_file
from ..datasets.kitti.kitti_dataset import create_kitti_infos


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('dataset', choices=['kitti'])
    parser.add_argument('--cfg_file', type=str,
                        default='tools/cfgs/pointpillar.yaml')
    parser.add_argument('--data_path', type=str, default=None)
    parser.add_argument('--save_path', type=str, default=None)
    parser.add_argument('--workers', type=int, default=4)
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    create_kitti_infos(cfg, data_path=args.data_path,
                       save_path=args.save_path, workers=args.workers)


if __name__ == '__main__':
    main()
