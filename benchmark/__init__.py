"""The benchmark of mcmda_tpu_torch: see run.py."""
