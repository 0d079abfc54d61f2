"""The benchmark of diffopt_tpu_torch, the PyTorch / CUDA port: ``run.py`` runs one cell once."""
