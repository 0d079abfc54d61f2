"""K6, the fused conic interior-point kernel (``csrc/conic_pdip.cu``): the work of one launch on a batch
of programs with zero, nonnegative and second-order cone rows (no psd block).

Bytes: c, b, A read once, x, y, s, the counts and residuals written once. Operations: a body with its
metrics as ``chip_smoke.py::_conic_pdip_flops`` counts them, for as many bodies as the benchmark's plain
reference needs on these inputs to reach the cell's tolerance, and per instance the init and three metric
evaluations."""

PATTERN = "conic_kernel"


def launches() -> dict:
    """The port's own launch counter of the kernel: launches so far, by shape."""
    from diffopt_tpu_torch.ops.cuda import conic_pdip

    return {(): conic_pdip.solve_tile_fused.launches}


def body_metrics_init(n, p, l, soc_dims):
    mC = l + sum(soc_dims)
    N = n + p + mC
    passes = 1
    blocks = []
    if l:
        blocks.append((l, (2 * l, l, l, l, 2 * l, 0, 2 * l, 1)))
    for d in soc_dims:
        blocks.append((d, (13 * d + 30, 6 * d, 5 * d, 7 * d + 10, 6 * d + 20, 0, 2 * d, 4)))
    nt = sum(b[0] for _, b in blocks)
    w_apply = sum(b[1] for _, b in blocks)
    jmul = sum(b[2] for _, b in blocks)
    jsolve = sum(b[3] for _, b in blocks)
    step = sum(b[4] for _, b in blocks)
    lam_eigs = sum(b[5] for _, b in blocks)
    shift = sum(b[6] for _, b in blocks)
    w2 = sum(dim * dim * cost for dim, (*_, cost) in blocks)
    factor = N**3 / 3 + N * N + w2 / 2
    ldl_solve = 2 * N * N - N
    residual = w2 + 2 * sum(dim * dim for dim, _ in blocks) + 4 * mC * n + 4 * p * n + 3 * N
    solve = 3 * w_apply + (1 + passes) * ldl_solve + passes * (residual + N) + 3 * mC
    body = nt + factor + w_apply + lam_eigs + 2 * solve + 4 * w_apply + 4 * step + 2 * jmul + jsolve
    body += 8 * mC + 2 * (n + p + 2 * mC)
    metrics = 4 * n * (mC + p) + 14 * mC + 10 * p + 11 * n
    init = nt + factor + solve + 2 * mC * n + shift
    return body, metrics, init


def work(rec, iterations):
    cfg, B = rec["config"], rec["batch"]
    n, item = cfg["n"], 4 if cfg["dtype"] == "float32" else 8
    kinds = [c[0] for c in cfg["cones"]]
    if set(kinds) - {"zero", "nonneg", "soc"}:
        return []
    p = sum(c[1] for c in cfg["cones"] if c[0] == "zero")
    l = sum(c[1] for c in cfg["cones"] if c[0] == "nonneg")
    socs = [c[1] for c in cfg["cones"] if c[0] == "soc"]
    mC = l + sum(socs)
    body, metrics, init = body_metrics_init(n, p, l, socs)
    its = iterations(rec["traffic"]["kwargs"]["tol"])
    launches = sum(rec["counters"]["K6"].values())
    nbytes = B * item * ((p + mC) * (n + 1) + n + (n + p + 2 * mC + 2) + 1)
    flops = B * (its * (body + metrics) + init + 3 * metrics)
    return [(nbytes, flops)] * launches
