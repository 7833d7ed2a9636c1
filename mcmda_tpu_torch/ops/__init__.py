"""Layers and residual blocks of the eval-mode forward."""
