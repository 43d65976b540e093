"""The official KITTI AP evaluator and its native host functions."""
