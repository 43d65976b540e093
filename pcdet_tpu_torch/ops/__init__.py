"""Box overlap, NMS and voxelization on tensors, and the CUDA kernel wrappers."""
