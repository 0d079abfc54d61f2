"""K3, the batched LDL' solve (``csrc/tri_solve.cuh`` with the LDL' diagonal): per launch at (N, k), the
strict lower triangle of L, d and the right-hand sides read once, the solutions written once; 2 N^2 k
operations an instance. Shapes from the port's launch counter."""

PATTERN = "LdlDiag"


def launches() -> dict:
    """The port's own launch counter of the kernel: launches so far, by shape."""
    from diffopt_tpu_torch.ops.cuda import chol

    return dict(chol.ldl_solve_batched.launches_by_shape)


def work(rec, iterations):
    B, item = rec["batch"], 4 if rec["config"]["dtype"] == "float32" else 8
    return [(B * item * (N * (N - 1) // 2 + N + 2 * N * k), B * 2 * N * N * k)
            for (N, k), count in rec["counters"]["K3"].items() for _ in range(count)]
