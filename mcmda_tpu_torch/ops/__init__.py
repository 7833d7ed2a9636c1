"""Layers, residual blocks and losses of the segmenter."""
