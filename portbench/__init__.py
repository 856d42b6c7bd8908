"""The benchmark of minigraph_tpu_torch on one H100 (see README.md)."""
