"""Math helpers on tensors."""
