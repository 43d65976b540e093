"""Synthetic LiDAR scenes for the detect and train entry points."""
