"""PyTorch + CUDA port of mcmda_tpu (PnP-AdaNet) for NVIDIA Hopper GPUs.

The JAX package ``mcmda_tpu`` is the reference; this package mirrors its
module names.  It imports ``torch`` and never ``jax`` or ``mcmda_tpu``.
Public functions keep the JAX layouts: NHWC activations, HWIO weights.
"""

__version__ = "0.1.0"
