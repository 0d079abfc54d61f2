"""K1, the fused QP interior-point kernel (``csrc/pdip.cu``): the work of one launch on a batch.

Bytes: Q, q, A, b, G, h read once, z, lam, nu and the iteration count written once. Operations: one
interior-point body as the kernel arranges it (``chip_smoke.py::pdip_flops_per_iteration``), for as many
bodies as the benchmark's plain reference needs on these inputs to reach the kernel's float32 criterion,
the init counted as one more body."""

PATTERN = "pdip_kernel"
TOL = 5e-6  # the fused solver's float32 tolerance (its scale-relative criterion)


def launches() -> dict:
    """The port's own launch counter of the kernel: launches so far, by shape."""
    from diffopt_tpu_torch.ops.cuda import pdip

    return {(): pdip.solve_batched_fused.launches}


def flops_per_iteration(n, m, p):
    factor = n * (n + 1) * m + n**3 / 3 + n * n * p + p * (p + 1) * n + p**3 / 3
    direction = 2 * n * n + 2 * p * p + 4 * n * p + 4 * m * n
    residuals = 2 * n * n + 4 * m * n + 4 * p * n
    return factor + 2 * direction + residuals


def work(rec, iterations):
    """[(bytes, flops)] of the launches in the window; ``iterations`` maps a tolerance to the reference's
    mean iterations."""
    cfg, B = rec["config"], rec["batch"]
    n, m, p, item = cfg["n"], cfg["m"], cfg["p"], 4 if cfg["dtype"] == "float32" else 8
    launches = sum(rec["counters"]["K1"].values())
    nbytes = B * item * (n * n + (m + p) * (n + 1) + n + (n + 2 * m + p) + 1)
    flops = B * (iterations(TOL) + 1) * flops_per_iteration(n, m, p)
    return [(nbytes, flops)] * launches
