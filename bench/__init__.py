"""The benchmark of the PyTorch and CUDA port (``repro_torch``): AlexNet and
GoogLeNet served through its tier on one H100.  ``bench/run.py`` runs one
cell; ``BENCHMARK.json`` at the repository's root lists the cells."""
