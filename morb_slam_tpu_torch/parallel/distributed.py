"""Multi-process wiring over `torch.distributed` (counterpart of
`morb_slam_tpu/parallel/distributed.py`).

Usage, one call a process before any collective:

    from morb_slam_tpu_torch.parallel import distributed
    distributed.initialize(coordinator="host0:1234", num_processes=2,
                           process_id=int(os.environ["RANK"]))
    mesh = distributed.global_obs_mesh()
    R, t, X, info = distributed.global_ba_distributed(problem, mesh)

The card's processes use the `nccl` backend and one card each
(`cuda:local_rank`); `device_type="cpu"` asks for `gloo` on the CPU
instead. A single process needs no `initialize`: `global_obs_mesh` makes
the one-rank group itself. Nothing is read from the environment but
LOCAL_RANK, where a launcher sets it.
"""
from __future__ import annotations

import os
import socket
import time

import torch
import torch.distributed as dist

from . import sharded_ba

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"distributed: unsupported device type "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("distributed: no CUDA device; pass "
                           "device_type='cpu' for the gloo backend")
    return BACKENDS[device_type]


def _local_rank() -> int:
    n = max(torch.cuda.device_count(), 1)
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() % n))


def initialize(coordinator: str = None, num_processes: int = 1,
               process_id: int = 0, local_device_ids=None,
               device_type: str = "cuda"):
    """Join the job's process group: `init_process_group` over
    tcp://coordinator ("host:port") with `num_processes` ranks, nccl for
    the card and gloo for device_type="cpu". A no-op for one process, so
    one launch script serves one process and many. local_device_ids: the
    card this process drives (its first entry)."""
    if num_processes <= 1:
        return
    backend = _backend(device_type)
    if device_type == "cuda" and local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def global_obs_mesh(device_type: str = "cuda"):
    """1-D observation-sharding DeviceMesh over every rank of the job, its
    dimension named OBS_AXIS; each rank on cuda:local_rank, or on the CPU
    where device_type is "cpu". A process outside any group makes its own
    one-rank group (over a free local port) first."""
    from torch.distributed.device_mesh import init_device_mesh
    backend = _backend(device_type)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
            world_size=1, rank=0)
    if device_type == "cuda":
        torch.cuda.set_device(_local_rank())
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(sharded_ba.OBS_AXIS,))


def global_ba_distributed(problem, mesh=None, n_iters: int = 10,
                          pcg: bool = True, cg_iters: int = 24):
    """Global bundle adjustment over the job's mesh: the observations
    padded to the mesh size, then the observation-sharded PCG solver
    (nothing K x L formed) or, with pcg=False, the dense-Schur LM solver.
    mesh: default `global_obs_mesh` on the problem's device type."""
    if mesh is None:
        mesh = global_obs_mesh(problem.obs_uv.device.type)
    problem = sharded_ba.pad_problem_for_mesh(problem, mesh.size())
    if pcg:
        return sharded_ba.ba_solve_pcg_sharded(problem, mesh,
                                               n_iters=n_iters,
                                               cg_iters=cg_iters)
    return sharded_ba.ba_solve_sharded(problem, mesh, n_iters=n_iters)


def ba_scaling_efficiency(problem, n_iters: int = 2, cg_iters: int = 12,
                          mesh=None):
    """Measured BA scaling efficiency of the job: LM iterations a second of
    `ba_solve_pcg_sharded` over the whole mesh and over a one-rank group
    (`new_group([0])`, run on rank 0 and broadcast), normalized by the
    rank count. Each run is timed after an untimed warm-up, the card
    synchronized. Returns (ips_full, ips_1, efficiency) on every rank."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh is None:
        mesh = global_obs_mesh(problem.obs_uv.device.type)
    n = mesh.size()
    dev = problem.obs_uv.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def run(m):
        p = sharded_ba.pad_problem_for_mesh(problem, m.size())
        sharded_ba.ba_solve_pcg_sharded(p, m, n_iters=n_iters,
                                        cg_iters=cg_iters)
        sync()
        t0 = time.perf_counter()
        sharded_ba.ba_solve_pcg_sharded(p, m, n_iters=n_iters,
                                        cg_iters=cg_iters)
        sync()
        return n_iters / (time.perf_counter() - t0)

    ips_full = run(mesh)
    one = dist.new_group([0])
    ips = torch.zeros(1, dtype=torch.float64, device=dev)
    if dist.get_rank() == 0:
        ips[0] = run(DeviceMesh.from_group(one, dev.type,
                                           mesh_dim_names=(
                                               sharded_ba.OBS_AXIS,)))
    dist.broadcast(ips, src=0, group=mesh.get_group())
    ips_1 = float(ips[0])
    return ips_full, ips_1, ips_full / (ips_1 * n)
