"""Measurement scripts of the port; each runs on one NVIDIA GPU, as
``python3 -m diffopt_tpu_torch.tools.<name>`` from the repository root."""
