"""K2, the batched LDL' factor (``csrc/ldl.cu``): per launch at size N, the lower triangle of K read once,
L and d written once; N^3 / 3 operations an instance. Shapes from the port's launch counter."""

PATTERN = "ldl_factor_"


def launches() -> dict:
    """The port's own launch counter of the kernel: launches so far, by shape."""
    from diffopt_tpu_torch.ops.cuda import chol

    return dict(chol.ldl_batched.launches_by_shape)


def work(rec, iterations):
    B, item = rec["batch"], 4 if rec["config"]["dtype"] == "float32" else 8
    return [(B * item * (N * (N + 1) // 2 + N * N + N), B * N**3 / 3)
            for (N, _), count in rec["counters"]["K2"].items() for _ in range(count)]
