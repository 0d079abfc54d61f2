"""Hand-written CUDA C++ kernels for Hopper (``sm_90a``), with the plain
PyTorch version of each beside its wrapper. Counterpart of
``diffopt_tpu/ops/pallas/``. Nothing here touches ``nvcc`` or the card at
import time: the sources under ``csrc/`` are compiled at first launch."""
