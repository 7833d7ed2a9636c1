"""Training: optimizer, source-segmenter step, loop."""
