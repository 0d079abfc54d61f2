"""Dense KKT math (``kkt``) and the Hopper kernels (``cuda``)."""
