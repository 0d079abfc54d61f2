"""The port's multi-process modules (``diffopt_tpu_torch/parallel``) on the CPU.

One spawn of two gloo processes (``_torch_parallel_worker.py``) covers
``initialize_multihost``, ``hybrid_mesh``, ``scenario_sharding``, the sharded
``solve_two_stage`` + forward sensitivity against the one-process result at
S = 16, ``shard_batch`` and ``tp_cholesky`` / ``tp_solve_psd`` against a local
Cholesky; single-process tests cover the rest. No JAX call: the JAX
package's parallel tests are the reference's own, and the port's Schur path
is held to the JAX package in ``test_torch_schur.py``."""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from diffopt_tpu_torch.parallel import (batch_pad, global_mesh, hybrid_mesh, initialize_multihost, make_mesh,
                                        profile_trace, runtime, sharding)
from diffopt_tpu_torch.utils.testing import make_batch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_two_process_gloo():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = str(ROOT)
    worker = pathlib.Path(__file__).with_name("_torch_parallel_worker.py")
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i), str(port)], env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for i in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MPOK {i} " in out, f"worker {i} output:\n{out}"
    # both processes hold the same replicated coupling solution
    z0 = [out.split(f"MPOK {i} ")[1].split()[0] for i, out in enumerate(outs)]
    assert z0[0] == z0[1], z0


def test_batch_pad_repeats_the_first_instance():
    x = {"a": torch.arange(24.0).reshape(6, 4), "s": torch.tensor(3.0), "k": 2}
    padded = batch_pad(x, 8)
    assert padded["a"].shape == (8, 4)
    assert torch.equal(padded["a"][6], x["a"][0]) and torch.equal(padded["a"][7], x["a"][0])
    assert torch.equal(padded["a"][:6], x["a"])
    assert padded["s"] is x["s"] and padded["k"] == 2  # scalar leaves have no batch dim
    assert batch_pad(x, 3)["a"] is x["a"]  # already a multiple: untouched
    # the port's dataclasses are trees too: every field padded, the type kept
    qp = make_batch(3, 4, 2, 1, torch.float64, "cpu")
    padded = batch_pad(qp, 4)
    assert type(padded) is type(qp) and all(t.shape[0] == 4 for t in padded.tensors())
    assert all(torch.equal(t[3], t[0]) for t in padded.tensors())


def test_initialize_multihost_single_process_noop(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_multihost(num_processes=1)
    initialize_multihost()  # no launcher environment: a no-op
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        initialize_multihost(num_processes=2)  # explicit, but no coordinator: raises


def test_hybrid_mesh_errors():
    # one process (no process group): 1 does not split over 3, and 2 x 2 is not 1
    with pytest.raises(ValueError, match="do not split"):
        hybrid_mesh(dcn=3)
    with pytest.raises(ValueError, match="!= 1 processes"):
        hybrid_mesh(dcn=2, ici=2)
    assert runtime.default_backend() == ("cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo")


def test_meshes_stay_on_the_host_when_asked(monkeypatch):
    """device="cpu" keeps a mesh on the host even where a card is seen (one gloo process); without it the
    card is the default wherever there is one."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert sharding._device_type() == "cuda" and sharding._device_type(torch.device("cpu")) == "cpu"
        meshes = (make_mesh(device="cpu"), make_mesh(1, "tp", device=torch.device("cpu")),
                  global_mesh(device="cpu"), hybrid_mesh(1, 1, device="cpu"))
        assert [m.device_type for m in meshes] == ["cpu"] * 4
        assert meshes[1].mesh_dim_names == ("tp",) and meshes[3].shape == (1, 1)
    finally:
        dist.destroy_process_group()


def test_profile_trace_writes_trace(tmp_path):
    log_dir = tmp_path / "torch-trace"
    with profile_trace(str(log_dir)):
        y = torch.ones(8, 8) @ torch.ones(8, 8)
    assert float(y[0, 0]) == 8.0
    files = list(log_dir.iterdir())
    assert [f.name for f in files] == ["trace.rank0.json"]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
