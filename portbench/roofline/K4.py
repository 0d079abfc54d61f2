"""K4, the batched Cholesky factor (``csrc/chol.cu``): per launch at size n, the lower triangle of H read
once and L written once; n^3 / 3 operations an instance. Shapes from the port's launch counter."""

PATTERN = "chol_factor_"


def launches() -> dict:
    """The port's own launch counter of the kernel: launches so far, by shape."""
    from diffopt_tpu_torch.ops.cuda import chol

    return dict(chol.cholesky_batched.launches_by_shape)


def work(rec, iterations):
    B, item = rec["batch"], 4 if rec["config"]["dtype"] == "float32" else 8
    return [(B * item * (n * (n + 1) // 2 + n * n), B * n**3 / 3)
            for (n, _), count in rec["counters"]["K4"].items() for _ in range(count)]
