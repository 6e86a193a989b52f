"""The benchmark of demfi_torch: see ``benchmark/run.py``."""
