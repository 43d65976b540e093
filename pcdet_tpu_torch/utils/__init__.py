"""Math helpers on tensors, and numpy helpers of the data path."""
