"""Volume inference and 3D post-processing."""
