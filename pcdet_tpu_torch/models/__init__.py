"""PointPillar modules as torch nn.Modules."""
