"""Host utilities: checkpoints, per-step seeds, metric logging."""
