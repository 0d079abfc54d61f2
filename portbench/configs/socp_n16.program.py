"""The configuration's data as the measured program takes it: a ``ConeProgram`` over the configuration's
cones."""


def make(d: dict, cfg: dict):
    import diffopt_tpu_torch as dtt

    spec = dtt.ConeSpec([tuple(block) for block in cfg["cones"]])
    return dtt.ConeProgram(A=d["A"], b=d["b"], c=d["c"], cones=spec)
