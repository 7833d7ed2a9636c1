"""Benchmark constants (copy of the serving subset of
``mcmda_tpu/data/splits.py``)."""

# benchmark structures: class id -> name (MMWHS cardiac substructures)
STRUCTURES = {1: "AA", 2: "LAC", 3: "LVC", 4: "MYO"}
