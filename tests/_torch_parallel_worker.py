"""One process of the two-process gloo run of ``tests/test_torch_parallel.py``.

``python tests/_torch_parallel_worker.py <rank> <port>``: initializes the
default process group over ``127.0.0.1:<port>`` (two processes, gloo), builds
the hybrid DCN x ICI mesh and the global meshes, shards a two-stage scenario
batch over the hybrid one, and
checks against the same process's one-process results: the sharded
``solve_two_stage`` and forward sensitivity (S = 16), ``shard_batch`` on a
1-D mesh, and ``tp_cholesky`` / ``tp_solve_psd`` against a local Cholesky.
Prints ``MPOK <rank> <z[0]>`` when every check holds.
"""

import sys

import numpy as np
import torch


def two_stage(S, n=4, m=3, p=2, c=3, seed=0):
    """The JAX package's test problem (``tests/test_schur.py::_random_two_stage``), f64 on the host."""
    from diffopt_tpu_torch.parallel.schur import TwoStageQP

    rng = np.random.default_rng(seed)
    L = rng.normal(size=(S, n, n))
    L0 = rng.normal(size=(c, c))
    arrays = dict(
        Qs=L @ np.transpose(L, (0, 2, 1)) + n * np.eye(n), qs=rng.normal(size=(S, n)), As=rng.normal(size=(S, p, n)),
        bs=rng.normal(size=(S, p)), Gs=rng.normal(size=(S, m, n)), hs=rng.normal(size=(S, m)) + 2.0,
        Bs=rng.normal(size=(S, p, c)), Q0=L0 @ L0.T + c * np.eye(c), q0=rng.normal(size=c),
    )
    return TwoStageQP(**{k: torch.as_tensor(v) for k, v in arrays.items()})


def spd(n, seed):
    M = np.random.default_rng(seed).normal(size=(n, n))
    return torch.as_tensor(M @ M.T + n * np.eye(n))


def main() -> None:
    rank, port = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from diffopt_tpu_torch.parallel import (global_mesh, hybrid_mesh, initialize_multihost, make_mesh,
                                            scenario_sharding, shard_batch)
    from diffopt_tpu_torch.parallel.schur import TwoStageQP, solve_two_stage, two_stage_forward_sensitivity
    from diffopt_tpu_torch.parallel.tp_chol import tp_cholesky, tp_solve_psd

    initialize_multihost(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=rank)
    assert dist.is_initialized() and dist.get_world_size() == 2 and dist.get_rank() == rank
    assert dist.get_backend() == "gloo", dist.get_backend()

    # one process a host here: two DCN granules of one process each
    mesh = hybrid_mesh()
    assert mesh.shape == (2, 1) and mesh.mesh_dim_names == ("dcn", "ici"), (mesh.shape, mesh.mesh_dim_names)
    sh = scenario_sharding(mesh)
    assert (sh.index, sh.count) == (rank, 2), sh
    mesh2 = global_mesh(axis_names=("dp", "mp"), shape=(1, 2))
    assert mesh2.shape == (1, 2) and tuple(mesh2.get_coordinate()) == (0, rank), mesh2.get_coordinate()
    assert global_mesh().shape == (2,)

    # the sharded two-stage solve and forward sensitivity against this process's one-process run
    S, tol = 16, 1e-9
    ts = two_stage(S, seed=5)
    dts = two_stage(S, seed=3)
    ref, ref_info = solve_two_stage(ts)
    ref_fwd = two_stage_forward_sensitivity(ts, ref, dts)
    assert bool(ref_info.converged), ref_info
    # the scenario fields are sharded, the coupling fields Q0 and q0 replicated
    local = TwoStageQP(*sh.shard(ts.tensors()[:7]), ts.Q0, ts.q0)
    dlocal = TwoStageQP(*sh.shard(dts.tensors()[:7]), dts.Q0, dts.q0)
    sol, info = solve_two_stage(local, group=sh.group)
    assert bool(info.converged) and int(info.iterations) == int(ref_info.iterations), (info, ref_info)
    fwd = two_stage_forward_sensitivity(local, sol, dlocal, group=sh.group)
    rows = slice(rank * S // 2, (rank + 1) * S // 2)
    for name, a, b in (("xs", sol.xs, ref.xs[rows]), ("lams", sol.lams, ref.lams[rows]), ("nus", sol.nus, ref.nus[rows]),
                       ("z", sol.z, ref.z), ("dxs", fwd.xs, ref_fwd.xs[rows]), ("dz", fwd.z, ref_fwd.z),
                       ("dlams", fwd.lams, ref_fwd.lams[rows])):
        err = float((a - b).abs().max())
        assert err <= tol * (1.0 + float(b.abs().max())), (name, err)
    for name, v in (("primal_residual", info.primal_residual), ("dual_residual", info.dual_residual),
                    ("duality_gap", info.duality_gap)):
        assert abs(float(v) - float(getattr(ref_info, name))) <= 1e-9 * (1.0 + abs(float(v))), name

    # shard_batch over a 1-D mesh: this process's half of the leading dimension, shared scalars kept whole
    mesh1 = make_mesh(axis_name="tp")
    part = shard_batch({"a": torch.arange(24.0).reshape(6, 4), "s": torch.tensor(3.0)}, mesh1, "tp")
    assert torch.equal(part["a"], torch.arange(24.0).reshape(6, 4)[3 * rank : 3 * rank + 3]) and float(part["s"]) == 3.0
    group = mesh1.get_group("tp")

    # the block-column Cholesky and solve against a local factorization
    H = spd(32, 0)
    cols = slice(16 * rank, 16 * (rank + 1))
    L_local = tp_cholesky(H[:, cols].contiguous(), group)
    assert float((L_local - torch.linalg.cholesky(H)[:, cols]).abs().max()) <= 1e-10
    H = spd(40, 1)
    r = torch.as_tensor(np.random.default_rng(2).normal(size=40))
    z_local = tp_solve_psd(H[:, 20 * rank : 20 * (rank + 1)].contiguous(), r[20 * rank : 20 * (rank + 1)], group)
    assert float((z_local - torch.linalg.solve(H, r)[20 * rank : 20 * (rank + 1)]).abs().max()) <= 1e-9

    dist.barrier()
    dist.destroy_process_group()
    print(f"MPOK {rank} {float(sol.z[0])!r}", flush=True)


if __name__ == "__main__":
    main()
