"""KITTI: the official AP evaluator."""
