"""The card a run measures on: its name, count, clocks, power and temperature, and the check that no
module of JAX or of the JAX package was loaded."""

from __future__ import annotations

import subprocess
import sys

# top-level module names a run may not load (compared whole: diffopt_tpu_torch is the port and allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "diffopt_tpu", "__graft_entry__")

CLOCK_FIELDS = ("name", "power.limit", "clocks.sm", "power.draw", "temperature.gpu", "clocks_throttle_reasons.active")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def clocks() -> dict:
    """One ``nvidia-smi`` reading of the first card: the fields of ``CLOCK_FIELDS`` as printed (the last
    is left out where the installed NVIDIA driver does not know its name)."""
    for fields in (CLOCK_FIELDS, CLOCK_FIELDS[:-1]):
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0:
            values = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
            return dict(zip(fields, values))
    return {"error": out.stdout.strip() + out.stderr.strip()}


def sm_mhz(reading: dict) -> float | None:
    try:
        return float(reading["clocks.sm"].split()[0])
    except (KeyError, ValueError, IndexError):
        return None
