"""KITTI: the dataset, its info files and GT database, and the official AP
evaluator."""
