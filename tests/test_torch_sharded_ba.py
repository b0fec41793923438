"""The port's multi-device slice (`morb_slam_tpu_torch/parallel/` and
`vocab/database.py` top_candidates_sharded) against the JAX package, on
CPU tensors over two `gloo` ranks: the cases of tests/test_sharded_ba.py,
on its seeds and `build_problem`, at its tolerances.

The two ranks start once for the module (`tests/torch_dist_cases.py`, one
process each, one thread each) and run every case in the same group; the
tests read what they returned. Where the JAX sharded function is cheap
(the padding, the partition, the sharded place recognition on a two-device
mesh) it is the reference itself; for the solvers the reference is JAX's
single-device solver, which tests/test_sharded_ba.py holds equal to the
sharded one. Every rank must return the same R, t and X bit for bit: the
replicated state of a `shard_map` program.
"""
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from morb_slam_tpu.optim import ba as j_ba
from morb_slam_tpu.parallel import sharded_ba as j_sharded
from morb_slam_tpu.vocab import database as j_kfdb
from morb_slam_tpu_torch.optim import ba as t_ba
from morb_slam_tpu_torch.parallel import distributed
from morb_slam_tpu_torch.parallel import sharded_ba as t_sharded

from test_optim import build_problem

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2


def _np_problem(prob):
    return {k: np.asarray(v) for k, v in prob._asdict().items()}


def _t_problem(prob):
    return t_ba.BAProblem(**{k: torch.from_numpy(np.array(v))
                             for k, v in prob._asdict().items()})


def _drop_last_obs(prob):
    """The problem without its last observation (1,799 of them: the
    two-rank padding adds one masked row)."""
    return prob._replace(**{k: getattr(prob, k)[:-1] for k in (
        "obs_kf", "obs_lm", "obs_uv", "obs_ur", "obs_info", "obs_mask")})


def _mask_second_half(prob):
    """The problem with its second half of observations masked (keyframes
    3-5 unobserved): the second rank's shard has no active observation."""
    O = prob.obs_mask.shape[0]
    return prob._replace(obs_mask=prob.obs_mask.at[O // 2:].set(False))


def _fix_landmarks(prob):
    """The problem with every fifth landmark held fixed."""
    L = prob.lm_opt.shape[0]
    return prob._replace(lm_opt=jnp.asarray(np.arange(L) % 5 != 0))


def _no_obs(prob):
    return prob._replace(**{k: getattr(prob, k)[:0] for k in (
        "obs_kf", "obs_lm", "obs_uv", "obs_ur", "obs_info", "obs_mask")})


def _bow():
    rng = np.random.default_rng(7)
    bow = rng.random((64, 256)).astype(np.float32)
    return bow / bow.sum(axis=1, keepdims=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def problems():
    return {"dense40": build_problem(np.random.default_rng(40))[0],
            "dense41": build_problem(np.random.default_rng(41))[0],
            "pcg42": build_problem(np.random.default_rng(42))[0],
            "lm44": build_problem(np.random.default_rng(44))[0],
            "entry43": build_problem(np.random.default_rng(43))[0]}


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    """Each rank's results, the two ranks started once."""
    d = tmp_path_factory.mktemp("ranks")
    cases = {k: _np_problem(v) for k, v in problems.items()}
    cases["pcg42_odd"] = _np_problem(_drop_last_obs(problems["pcg42"]))
    cases["pcg42_half"] = _np_problem(_mask_second_half(problems["pcg42"]))
    cases["empty"] = _np_problem(_no_obs(problems["pcg42"]))
    cases["dense40_fixed"] = _np_problem(_fix_landmarks(problems["dense40"]))
    cases["bow"] = _bow()
    cases["bow_exclude"] = [11, 40]
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(cases, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_cases.py"), str(r),
         str(WORLD), str(port), str(d / "in.pkl"), str(d / f"out{r}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        finally:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = []
    for r in range(WORLD):
        with open(d / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _replicated(ranks, key, n=3):
    """Rank 0's result of `key` after checking every rank has the same
    first n outputs bit for bit."""
    first = ranks[0][key]
    for other in ranks[1:]:
        for a, b in zip(first[:n], other[key][:n]):
            np.testing.assert_array_equal(a, b)
    return first


def test_pad_problem_for_mesh(problems):
    """The padding equals the reference's: zeros, obs_ur NaN, obs_mask
    False (1,799 observations to 16 devices: 9 rows)."""
    prob = _drop_last_obs(problems["pcg42"])
    want = j_sharded.pad_problem_for_mesh(prob, 16)
    got = t_sharded.pad_problem_for_mesh(_t_problem(prob), 16)
    assert got.obs_uv.shape[0] == 1808
    for k, v in want._asdict().items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(v),
                                      err_msg=k)
    same = t_sharded.pad_problem_for_mesh(_t_problem(problems["pcg42"]), 8)
    assert same.obs_uv.shape[0] == 1800


def test_sharded_matches_single_device(ranks, problems):
    R, t, X, info = _replicated(ranks, "dense40")
    assert ranks[0]["mesh_size"] == ranks[0]["world"] == WORLD
    assert set(info) == {"cost0", "costs", "lambda"}
    R1, t1, X1, info1 = j_ba.ba_solve(problems["dense40"], n_iters=6)
    np.testing.assert_allclose(R, np.asarray(R1), atol=1e-5)
    np.testing.assert_allclose(t, np.asarray(t1), atol=1e-5)
    np.testing.assert_allclose(X, np.asarray(X1), atol=1e-4)
    np.testing.assert_allclose(info["costs"], np.asarray(info1["costs"]),
                               rtol=1e-4)


def test_sharded_with_fixed_landmarks(ranks, problems):
    """Every fifth landmark held fixed: the port's dense sharded solver
    weights a fixed landmark's coupling out of the reduced system, as K4
    and the single-device `ba_solve` of both packages do, and matches
    JAX's `ba_solve` at the tolerances above; the fixed landmarks do not
    move. JAX's `ba_solve_sharded` keeps that coupling (it subtracts
    B B^T for each fixed landmark) and so departs from both; the gap is
    measured here on a two-device mesh and must stay far outside the
    tolerance, or the two forms have come together."""
    prob = _fix_landmarks(problems["dense40"])
    R, t, X, info = _replicated(ranks, "dense40_fixed")
    R1, t1, X1, info1 = j_ba.ba_solve(prob, n_iters=6)
    np.testing.assert_allclose(R, np.asarray(R1), atol=1e-5)
    np.testing.assert_allclose(t, np.asarray(t1), atol=1e-5)
    np.testing.assert_allclose(X, np.asarray(X1), atol=1e-4)
    np.testing.assert_allclose(info["costs"], np.asarray(info1["costs"]),
                               rtol=1e-4)
    fixed = ~np.asarray(prob.lm_opt)
    np.testing.assert_array_equal(X[fixed], np.asarray(prob.X)[fixed])
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(WORLD),
                (j_sharded.OBS_AXIS,))
    Rs, ts, Xs, _ = j_sharded.ba_solve_sharded(
        j_sharded.pad_problem_for_mesh(prob, WORLD), mesh, n_iters=6)
    gap = {"R": np.abs(np.asarray(Rs) - R).max(),
           "t": np.abs(np.asarray(ts) - t).max(),
           "X": np.abs(np.asarray(Xs) - X).max()}
    print("gap to JAX's ba_solve_sharded with fixed landmarks:", gap)
    assert gap["t"] > 100 * 1e-5, gap


def test_sharded_converges(ranks):
    rng = np.random.default_rng(41)
    _, (R, t, X) = build_problem(rng)
    Rf, tf, Xf, info = _replicated(ranks, "dense41")
    assert float(info["costs"][-1]) < 0.5 * float(info["cost0"])
    np.testing.assert_allclose(Rf, np.asarray(R), atol=3e-3)


@pytest.mark.parametrize("case", ["pcg42", "pcg42_odd", "pcg42_half"])
def test_pcg_sharded_matches_single_device(ranks, problems, case):
    """The observation-sharded PCG against the single-device PCG; in
    pcg42_odd the second rank's shard ends in a padded, masked row, in
    pcg42_half it has no active observation."""
    prob = {"pcg42": lambda p: p, "pcg42_odd": _drop_last_obs,
            "pcg42_half": _mask_second_half}[case](problems["pcg42"])
    R1, t1, X1, info1 = j_ba.ba_solve_pcg(prob, n_iters=4, cg_iters=25)
    R8, t8, X8, info8 = _replicated(ranks, case)
    assert set(info8) == {"cost0", "costs", "lambda"}
    np.testing.assert_allclose(R8, np.asarray(R1), atol=2e-4)
    np.testing.assert_allclose(t8, np.asarray(t1), atol=2e-4)
    assert float(info8["costs"][-1]) < 0.8 * float(info8["cost0"])


@pytest.mark.parametrize("n_dev", [1, WORLD])
def test_pcg_lm_sharded_matches_single_device(ranks, problems, n_dev):
    """The landmark-sharded PCG through the reference's permutation (the
    port's partition equals it exactly) against the single-device PCG."""
    prob = problems["lm44"]
    R1, t1, X1, info1 = j_ba.ba_solve_pcg(prob, n_iters=4, cg_iters=25)
    pj, new2old_j = j_sharded.partition_problem_by_lm(prob, n_dev)
    Rn, tn, Xn, infon = _replicated(
        [{"r": r[f"lm44_{n_dev}"][0]} for r in ranks], "r")
    new2old = ranks[0][f"lm44_{n_dev}"][1]
    np.testing.assert_array_equal(new2old, np.asarray(new2old_j))
    for r in ranks:
        np.testing.assert_array_equal(r[f"lm44_{n_dev}"][1], new2old)
    assert Xn.shape == np.asarray(pj.X).shape
    np.testing.assert_allclose(Rn, np.asarray(R1), atol=2e-4)
    np.testing.assert_allclose(tn, np.asarray(t1), atol=2e-4)
    keep = new2old >= 0
    X_back = np.zeros_like(np.asarray(X1))
    X_back[new2old[keep]] = Xn[keep]
    np.testing.assert_allclose(X_back, np.asarray(X1), atol=5e-4)
    assert float(infon["costs"][-1]) < 0.8 * float(infon["cost0"])


def test_sharded_solvers_without_observations(ranks, problems):
    """A problem without observations: every shard empty, no kernel work;
    both observation-sharded solvers return the start state on every rank,
    at zero cost (the partition, as the reference's, needs
    observations)."""
    p = problems["pcg42"]
    for i, name in enumerate(("dense", "pcg")):
        R, t, X, info = _replicated(
            [{"r": r["empty"][i]} for r in ranks], "r")
        np.testing.assert_array_equal(R, np.asarray(p.R), err_msg=name)
        np.testing.assert_array_equal(t, np.asarray(p.t), err_msg=name)
        assert float(info["cost0"]) == 0.0 and not info["costs"].any()
    for r in ranks[0]["empty"]:
        np.testing.assert_array_equal(r[2], np.asarray(p.X))


def test_lm_partition_balances_observations():
    """Equal-observation boundaries on heavily clustered landmark ids: the
    port's partition equals the reference's array for array, and no block
    carries more than 1.3x the mean load."""
    rng = np.random.default_rng(45)
    K, L, O = 16, 4096, 60000
    lm = np.where(rng.random(O) < 0.8,
                  rng.integers(0, L // 10, O), rng.integers(0, L, O))
    prob = j_ba.make_problem(
        jnp.tile(jnp.eye(3), (K, 1, 1)), jnp.zeros((K, 3)),
        jnp.asarray(rng.normal(0, 1, (L, 3)), jnp.float32),
        jnp.asarray(rng.integers(0, K, O), jnp.int32),
        jnp.asarray(lm, jnp.int32),
        jnp.zeros((O, 2), jnp.float32), jnp.ones(O, jnp.float32),
        jnp.ones(O, bool), jnp.ones(K, bool), jnp.ones(L, bool))
    pj, nj = j_sharded.partition_problem_by_lm(prob, 8)
    pt, nt = t_sharded.partition_problem_by_lm(_t_problem(prob), 8)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    for k, v in pj._asdict().items():
        np.testing.assert_array_equal(getattr(pt, k).numpy(), np.asarray(v),
                                      err_msg=k)
    per_dev = pt.obs_mask.numpy().reshape(8, -1).sum(axis=1)
    assert per_dev.max() <= 1.3 * per_dev.mean(), per_dev


def test_sharded_place_recognition(ranks):
    """Keyframe-block-sharded BoW scoring equals the reference's sharded
    scoring on a two-device mesh and the replicated query."""
    bow = jnp.asarray(_bow())
    db = j_kfdb.KeyframeDatabase(bow=bow, valid=jnp.ones(64, bool))
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(WORLD), ("kf",))
    q = bow[11]
    exc = jnp.zeros(64, bool).at[jnp.asarray([11, 40])].set(True)
    for key, kw in (("pr", {}), ("pr_exclude", {"exclude": exc})):
        ids_r, sc_r, ok_r = j_kfdb.top_candidates(db, q, 3, **kw)
        ids_s, sc_s, ok_s = j_kfdb.top_candidates_sharded(db, q, 3, mesh,
                                                          **kw)
        ids, sc, ok = _replicated(ranks, key)
        np.testing.assert_array_equal(ids, np.asarray(ids_s))
        np.testing.assert_array_equal(ids, np.asarray(ids_r))
        np.testing.assert_array_equal(ok, np.asarray(ok_s))
        np.testing.assert_allclose(sc, np.asarray(sc_s), atol=1e-5)
        np.testing.assert_allclose(sc, np.asarray(sc_r), atol=1e-5)
    assert int(ranks[0]["pr"][0][0]) == 11
    assert 11 not in ranks[0]["pr_exclude"][0].tolist()


def test_distributed_entry_points(ranks):
    """The wiring: the single-process no-op initialize, the two ranks'
    global mesh (their `initialize` over tcp on gloo), the padded
    distributed GBA in both forms, and the scaling-efficiency
    measurement (the same figures on every rank)."""
    import torch.distributed as dist
    distributed.initialize(num_processes=1)          # must be a no-op
    assert not dist.is_initialized()
    for key in ("entry43", "entry43_dense"):
        R, t, X, info = _replicated(ranks, key)
        assert float(info["costs"][-1]) < 0.8 * float(info["cost0"]), key
    ips_n, ips_1, eff = ranks[0]["efficiency"]
    assert ips_n > 0 and ips_1 > 0 and np.isfinite(eff)
    assert eff == pytest.approx(ips_n / (ips_1 * WORLD))
    assert ranks[1]["efficiency"][1] == ips_1
