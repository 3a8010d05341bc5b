"""cryobench: the benchmark of xmipp3_tpu_torch on the card (run.py)."""
