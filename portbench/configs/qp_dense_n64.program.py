"""The configuration's data as the measured program takes it: a ``QuadProgram`` of the six tensors."""


def make(d: dict, cfg: dict):
    import diffopt_tpu_torch as dtt

    return dtt.QuadProgram(**d)
