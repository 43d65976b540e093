"""Training augmentations: per-object and global noise, GT database
sampling."""
