"""One rank of the two-rank `gloo` group that tests/test_torch_sharded_ba.py
starts once per module: it joins the group through the port's
`parallel.distributed.initialize`, runs every case of the multi-device
slice on its rank (CPU tensors, so every kernel wrapper runs its plain
version) and pickles what it returns. Imports torch and the port only.

    python tests/torch_dist_cases.py RANK WORLD PORT INPUTS.pkl OUT.pkl
"""
import pickle
import sys

import numpy as np
import torch


def _problem(d):
    from morb_slam_tpu_torch.optim import ba
    return ba.BAProblem(**{k: torch.from_numpy(np.asarray(v))
                           for k, v in d.items()})


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x.numpy() if torch.is_tensor(x) else x


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    inputs, out_path = sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from morb_slam_tpu_torch.parallel import distributed, sharded_ba
    from morb_slam_tpu_torch.vocab import database as kfdb

    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    distributed.initialize(f"127.0.0.1:{port}", world, rank,
                           device_type="cpu")
    mesh = distributed.global_obs_mesh("cpu")
    out = {"mesh_size": mesh.size(), "world": dist.get_world_size()}

    pad = sharded_ba.pad_problem_for_mesh
    p = _problem(cases["dense40"])
    out["dense40"] = sharded_ba.ba_solve_sharded(pad(p, world), mesh,
                                                 n_iters=6)
    p = _problem(cases["dense40_fixed"])
    out["dense40_fixed"] = sharded_ba.ba_solve_sharded(pad(p, world), mesh,
                                                       n_iters=6)
    p = _problem(cases["dense41"])
    out["dense41"] = sharded_ba.ba_solve_sharded(pad(p, world), mesh,
                                                 n_iters=12)
    for name in ("pcg42", "pcg42_odd", "pcg42_half"):
        p = _problem(cases[name])
        out[name] = sharded_ba.ba_solve_pcg_sharded(pad(p, world), mesh,
                                                    n_iters=4, cg_iters=25)

    # the landmark-sharded form over the two ranks and, on each rank, over
    # a one-rank group of its own
    p = _problem(cases["lm44"])
    own = [dist.new_group([r]) for r in range(world)][rank]
    meshes = {world: mesh,
              1: DeviceMesh.from_group(own, "cpu",
                                       mesh_dim_names=(sharded_ba.OBS_AXIS,))}
    for n_dev, m in meshes.items():
        pn, new2old = sharded_ba.partition_problem_by_lm(p, n_dev)
        out[f"lm44_{n_dev}"] = (sharded_ba.ba_solve_pcg_lm_sharded(
            pn, m, n_iters=4, cg_iters=25), new2old)

    # no observation at all: every shard empty
    p = _problem(cases["empty"])
    out["empty"] = [
        sharded_ba.ba_solve_sharded(p, mesh, n_iters=2),
        sharded_ba.ba_solve_pcg_sharded(p, mesh, n_iters=2, cg_iters=5)]

    kf_mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("kf",))
    bow = torch.from_numpy(cases["bow"])
    db = kfdb.KeyframeDatabase(bow=bow, valid=torch.ones(bow.shape[0],
                                                         dtype=torch.bool))
    exc = torch.zeros(bow.shape[0], dtype=torch.bool)
    exc[cases["bow_exclude"]] = True
    out["pr"] = kfdb.top_candidates_sharded(db, bow[11], 3, kf_mesh)
    out["pr_exclude"] = kfdb.top_candidates_sharded(db, bow[11], 3, kf_mesh,
                                                    exclude=exc)

    p = _problem(cases["entry43"])
    out["entry43"] = distributed.global_ba_distributed(p, mesh, n_iters=3,
                                                       cg_iters=20)
    out["entry43_dense"] = distributed.global_ba_distributed(
        p, mesh, n_iters=3, pcg=False)
    out["efficiency"] = distributed.ba_scaling_efficiency(p, n_iters=1,
                                                          cg_iters=8,
                                                          mesh=mesh)
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(_np(out), f)


if __name__ == "__main__":
    main()
