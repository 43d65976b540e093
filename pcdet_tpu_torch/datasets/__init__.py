"""Datasets of the port: KITTI-format trees and synthetic LiDAR scenes as
fixed-shape examples, the prefetching loader, and the KITTI evaluator."""
from .dataset import DatasetTemplate, collate_batch  # noqa: F401


def build_dataloader(cfg, batch_size, training=True, logger=None,
                     num_workers=4, host_id=0, num_hosts=1, seed=0,
                     worker_mode='thread'):
    """The dataset of `cfg.DATA_CONFIG.DATASET` and its prefetching loader
    (`pcdet_tpu.datasets.build_dataloader`, the reference's
    pcdet/datasets/__init__.py:16-33): shuffled, last batch dropped, in
    training; in index order, every sample kept, in evaluation.

    :return: (dataset, loader)
    """
    from .loader import DataLoader
    dataset_name = cfg.DATA_CONFIG.DATASET
    if dataset_name == 'KittiDataset':
        from .kitti.kitti_dataset import KittiDataset
        dataset = KittiDataset(cfg=cfg, training=training, logger=logger)
    elif dataset_name == 'SyntheticDataset':
        from .synthetic import SyntheticDataset
        dataset = SyntheticDataset(cfg=cfg, training=training)
    else:
        raise NotImplementedError(dataset_name)

    loader = DataLoader(dataset, batch_size=batch_size,
                        shuffle=training, num_workers=num_workers,
                        host_id=host_id, num_hosts=num_hosts,
                        drop_last=training, seed=seed,
                        worker_mode=worker_mode)
    return dataset, loader
