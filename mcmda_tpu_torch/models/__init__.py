"""The dilated-residual segmenter."""
