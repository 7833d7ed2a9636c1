"""Command-line scripts of the port, twins of the JAX package's
``scripts/``; run each with ``python -m mcmda_tpu_torch.scripts.<name>``
from the root of a checkout."""
