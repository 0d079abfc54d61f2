"""K5, the batched Cholesky solve (``csrc/tri_solve.cuh`` with the Cholesky diagonal): per launch at
(n, k), the lower triangle of L and the right-hand sides read once, the solutions written once; 2 n^2 k
operations an instance. Shapes from the port's launch counter."""

PATTERN = "CholDiag"


def launches() -> dict:
    """The port's own launch counter of the kernel: launches so far, by shape."""
    from diffopt_tpu_torch.ops.cuda import chol

    return dict(chol.cholesky_solve_batched.launches_by_shape)


def work(rec, iterations):
    B, item = rec["batch"], 4 if rec["config"]["dtype"] == "float32" else 8
    return [(B * item * (n * (n + 1) // 2 + 2 * n * k), B * 2 * n * n * k)
            for (n, k), count in rec["counters"]["K5"].items() for _ in range(count)]
