"""Synthetic LiDAR scenes for the detect, train and eval entry points, and
the KITTI evaluator."""
