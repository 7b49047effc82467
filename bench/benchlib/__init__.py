"""The benchmark of the PyTorch and CUDA port (``repro_torch``): its
harness, shared by every cell.  ``bench/run.py`` is its command."""
