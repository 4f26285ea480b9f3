"""Tools that run on the card beside ``chip_smoke.py``: ``gemm_ab`` builds
variants of the bf16 layer GEMMs side by side and times them in one run."""
