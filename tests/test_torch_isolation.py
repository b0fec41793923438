"""Isolation and device rules of the PyTorch port: it imports neither JAX
nor the JAX package, nor YAML or OpenCV at import time (the card's machine
has neither); its tracker and System refuse to run without a card unless
asked for the CPU; and its kernel wrappers never fall back to the plain
versions for a tensor that is not on the CPU. The walk over the package
covers every module, among them `vocab/`, `io/serialization.py`,
`solvers/pnp.py`, `imu.py`, `optim/inertial.py`, `optim/vi_ba.py` and the
loop-closing slice's `solvers/sim3.py`, `optim/pose_graph.py`,
`mapstate/atlas.py`, `pipeline/global_ba.py` and
`pipeline/loop_closing.py`; K13's wrappers (`optim/vi_ba.py`
inertial_system, inertial_cost) and K15's (`optim/pose_graph.py`
normal_equations) are held to the same device rules."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from morb_slam_tpu_torch import cameras, imu, system
from morb_slam_tpu_torch.io import config
from morb_slam_tpu_torch.ops import (fast, hamming, orb_descriptor, rectify,
                                     stereo)
from morb_slam_tpu_torch.optim import ba, pose_graph, pose_opt, vi_ba
from morb_slam_tpu_torch.pipeline import tracking
from morb_slam_tpu_torch.vocab import tree

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_imports_without_jax_or_reference_package():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys

        BLOCKED = {"jax", "jaxlib", "morb_slam_tpu", "yaml", "cv2"}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked import: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import morb_slam_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            morb_slam_tpu_torch.__path__, "morb_slam_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        importlib.import_module("chip_smoke")
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
        assert not loaded, loaded
        for need in ("vocab.tree", "vocab.database", "io.serialization",
                     "solvers.pnp", "optim.pose_opt", "imu", "optim.inertial",
                     "optim.vi_ba", "optim.ba", "solvers.sim3",
                     "optim.pose_graph", "mapstate.atlas",
                     "pipeline.global_ba", "pipeline.loop_closing"):
            assert "morb_slam_tpu_torch." + need in names, need
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_tracker_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tracking.TrackerConfig(width=64, height=48, focal=50.0, n_feat=50,
                                 max_kf=4, max_lm=100, n_levels=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tracking.Tracker(cameras.pinhole(50.0, 50.0, 32, 24), cfg)
    t = tracking.Tracker(cameras.pinhole(50.0, 50.0, 32, 24), cfg,
                         device="cpu")
    assert t.m.lm_pos.device.type == "cpu"


def test_system_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = config.Settings(cam1=config.CameraSettings(fx=50.0, fy=50.0, cx=32,
                                                   cy=24, width=64,
                                                   height=48))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        system.System(s, system.Sensor.MONOCULAR)
    sm = system.System(s, system.Sensor.MONOCULAR, device="cpu",
                       tracker_overrides=dict(max_kf=4, max_lm=100))
    assert sm.tracker.device.type == "cpu"


def _counts():
    return [dict(c) for c in (fast.LAUNCHES, orb_descriptor.LAUNCHES,
                              hamming.LAUNCHES, stereo.LAUNCHES,
                              rectify.LAUNCHES, pose_opt.LAUNCHES,
                              tree.LAUNCHES["vocab_transform"],
                              tree.LAUNCHES["bow_l1"], ba.LAUNCHES,
                              imu.LAUNCHES, vi_ba.LAUNCHES,
                              ba.SCHUR_LAUNCHES, vi_ba.INERTIAL_LAUNCHES,
                              pose_graph.LAUNCHES)]


def _voc(device):
    return tree.Vocabulary(
        centers=(torch.zeros((2, 8), dtype=torch.int32, device=device),
                 torch.zeros((4, 8), dtype=torch.int32, device=device)),
        weights=torch.ones(4, device=device), k=2)


def _pose_args(device, n=5):
    return (torch.eye(3, device=device), torch.zeros(3, device=device),
            torch.ones((n, 3), device=device), torch.zeros((n, 2),
                                                           device=device),
            torch.ones(n, device=device),
            torch.ones(n, dtype=torch.bool, device=device))


def _ba_args(device, K=2, L=3, O=4):
    z = lambda *s: torch.zeros(s, device=device)
    i = lambda n: torch.zeros(n, dtype=torch.int32, device=device)
    b = lambda n: torch.ones(n, dtype=torch.bool, device=device)
    p = ba.make_problem(R=torch.eye(3, device=device).expand(K, 3, 3),
                        t=z(K, 3) + torch.tensor([0.0, 0.0, 2.0],
                                                 device=device),
                        X=z(L, 3), obs_kf=i(O), obs_lm=i(O), obs_uv=z(O, 2),
                        obs_info=z(O) + 1.0, obs_mask=b(O), kf_opt=b(K),
                        lm_opt=b(L))
    return p, p.R, p.t, p.X


def _imu_args(device, n=4):
    z = torch.zeros((n, 3), device=device)
    calib = imu.ImuCalib(*(torch.zeros(s, device=device)
                           for s in ((3, 3), (3,), (6,), (6,))))
    return (z, z, torch.full((n,), 0.005, device=device),
            torch.ones(n, dtype=torch.bool, device=device),
            torch.zeros(6, device=device), calib)


def _pose_inertial_args(device, n=5):
    R0, t0, X, obs, info, valid = _pose_args(device, n)
    z = lambda *s: torch.zeros(s, device=device)
    eye = torch.eye(3, device=device)
    return (R0, t0, z(3), z(6), X, obs, info, valid, z(n), z(), eye, z(3),
            z(3), z(6), z() + 0.05, eye, z(3), z(3), z(3, 3), z(3, 3),
            z(3, 3), z(3, 3), z(3, 3), torch.eye(9, device=device), z(6),
            z(6) + 1.0)


def _vi_args(device, W=2):
    """A W-slot inertial window without visual rows, its state and K4's
    visual pose blocks."""
    z = lambda *s: torch.zeros(s, device=device)
    eye = lambda *s: torch.eye(3, device=device).expand(*s, 3, 3)
    f = lambda n: torch.zeros(n, dtype=torch.bool, device=device)
    i = lambda n: torch.zeros(n, dtype=torch.int32, device=device)
    p = vi_ba.VIBAProblem(
        R_wb=eye(W), p_wb=z(W, 3), v=z(W, 3), bias=z(W, 6), fix_pose=f(W),
        fix_vb=f(W), X=z(1, 3), lm_opt=f(1), obs_kf=i(0), obs_lm=i(0),
        obs_uv=z(0, 2), obs_ur=z(0), obs_info=z(0), obs_mask=f(0),
        baseline=z(), e_valid=~f(W), e_prev=i(W), e_dt=z(W) + 0.1,
        e_dR=eye(W), e_dV=z(W, 3), e_dP=z(W, 3), e_JRg=z(W, 3, 3),
        e_JVg=z(W, 3, 3), e_JVa=z(W, 3, 3), e_JPg=z(W, 3, 3),
        e_JPa=z(W, 3, 3), e_info=torch.eye(9, device=device).expand(W, 9, 9),
        e_bias0=z(W, 6), e_rw_info=z(W, 6) + 1.0,
        prior_bias_info=z(W, 6) + 1.0)
    return p, (p.R_wb, p.p_wb, p.v, p.bias), z(W, 6, 6), z(W, 6)


def _graph_args(device, K=3):
    ar = torch.arange(K, dtype=torch.int32, device=device)
    g = pose_graph.PoseGraph(
        s=torch.ones(K, device=device),
        R=torch.eye(3, device=device).expand(K, 3, 3),
        t=torch.zeros((K, 3), device=device), edge_i=ar,
        edge_j=torch.roll(ar, 1), edge_s=torch.ones(K, device=device),
        edge_R=torch.eye(3, device=device).expand(K, 3, 3),
        edge_t=torch.ones((K, 3), device=device),
        edge_w=torch.ones(K, device=device),
        fixed=torch.zeros(K, dtype=torch.bool, device=device))
    return g, g.s, g.R, g.t


@pytest.mark.parametrize("kernel", ["fast_select", "orb_describe",
                                    "hamming_top2", "stereo_sad",
                                    "remap_bilinear", "pose_opt",
                                    "vocab_transform", "bow_l1",
                                    "ba_assemble", "preintegrate",
                                    "pose_inertial", "ba_assemble_per_obs",
                                    "schur_lm_pass", "schur_kf_pass",
                                    "inertial_system", "inertial_cost",
                                    "normal_equations"])
def test_wrappers_refuse_other_devices(kernel):
    meta = torch.device("meta")
    before = _counts()
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "fast_select":
            fast.fast_select(torch.empty((48, 64), device=meta), 7.0, 20.0)
        elif kernel == "orb_describe":
            img = torch.empty((48, 64), device=meta)
            orb_descriptor.orb_describe(img, img, torch.zeros(
                (4, 2), dtype=torch.int32, device=meta))
        elif kernel == "hamming_top2":
            d = torch.empty((4, 8), dtype=torch.int32, device=meta)
            hamming.hamming_top2(d, d, torch.ones((4, 4), dtype=torch.bool,
                                                  device=meta))
        elif kernel == "stereo_sad":
            img = torch.empty((48, 64), device=meta)
            stereo.sad_refine(img, img, torch.zeros((3, 2), device=meta),
                              torch.zeros(3, device=meta))
        elif kernel == "pose_opt":
            pose_opt.optimize_pose(*_pose_args(meta))
        elif kernel == "vocab_transform":
            tree.transform(_voc(meta), torch.zeros((3, 8), dtype=torch.int32,
                                                   device=meta))
        elif kernel == "bow_l1":
            tree.l1_score(torch.zeros(4, device=meta),
                          torch.zeros((3, 4), device=meta))
        elif kernel == "ba_assemble":
            ba.assemble(*_ba_args(meta))
        elif kernel == "ba_assemble_per_obs":
            ba.assemble(*_ba_args(meta), per_obs=True)
        elif kernel == "schur_lm_pass":
            p = _ba_args(meta)[0]
            ba.schur_lm_pass(p, torch.zeros((4, 6, 3), device=meta),
                             torch.zeros((2, 6), device=meta),
                             torch.zeros((3, 3, 3), device=meta))
        elif kernel == "schur_kf_pass":
            p = _ba_args(meta)[0]
            ba.schur_kf_pass(p, torch.zeros((4, 6, 3), device=meta),
                             torch.zeros((3, 3), device=meta),
                             a=torch.zeros((2, 6), device=meta))
        elif kernel == "preintegrate":
            imu.preintegrate(*_imu_args(meta))
        elif kernel == "pose_inertial":
            vi_ba.optimize_pose_inertial(*_pose_inertial_args(meta),
                                         n_iters=1)
        elif kernel == "inertial_system":
            p, st, Hpp, bp = _vi_args(meta)
            vi_ba.inertial_system(p, *st, Hpp, bp)
        elif kernel == "inertial_cost":
            p, st, _, _ = _vi_args(meta)
            vi_ba.inertial_cost(p, *st)
        elif kernel == "normal_equations":
            pose_graph.normal_equations(*_graph_args(meta))
        else:
            rectify.remap_bilinear(torch.empty((48, 64), device=meta),
                                   torch.zeros((8, 8, 2), device=meta))
    assert _counts() == before


def test_wrappers_use_plain_versions_on_cpu():
    before = _counts()
    img = torch.rand((48, 64)) * 255
    fast.fast_select(img, 7.0, 20.0)
    orb_descriptor.orb_describe(img, img, torch.full((3, 2), 24,
                                                     dtype=torch.int32))
    d = torch.zeros((3, 8), dtype=torch.int32)
    hamming.hamming_top2(d, d, torch.ones((3, 3), dtype=torch.bool))
    stereo.sad_refine(img, img, torch.full((3, 2), 20.0), torch.full((3,),
                                                                     20.0))
    rectify.remap_bilinear(img, torch.zeros((8, 8, 2)))
    pose_opt.optimize_pose(*_pose_args("cpu"), n_rounds=1, n_iters=1)
    tree.transform(_voc("cpu"), torch.zeros((3, 8), dtype=torch.int32))
    tree.l1_score(torch.zeros(4), torch.zeros((3, 4)))
    ba.assemble(*_ba_args("cpu"))
    imu.preintegrate(*_imu_args("cpu"))
    vi_ba.optimize_pose_inertial(*_pose_inertial_args("cpu"), n_iters=1)
    ba.schur_lm_pass(_ba_args("cpu")[0], torch.zeros((4, 6, 3)),
                     torch.zeros((2, 6)), torch.eye(3).expand(3, 3, 3))
    p, st, Hpp, bp = _vi_args("cpu")
    H, b = vi_ba.inertial_system(p, *st, Hpp, bp)
    assert H.shape == (30, 30) and b.shape == (30,)
    H, b, c = pose_graph.normal_equations(*_graph_args("cpu"))
    assert H.shape == (21, 21) and b.shape == (21,) and c.dim() == 0
    after = _counts()
    for b, a in zip(before, after):
        assert a["plain"] == b["plain"] + 1
        assert a["kernel"] == b["kernel"]


def test_k4_per_obs_and_k14_use_plain_versions_on_cpu():
    """The global BA's kernels: K4's per-observation mode and each K14
    pass run their plain versions for CPU tensors."""
    p = _ba_args("cpu")[0]
    before = [dict(ba.LAUNCHES), dict(ba.SCHUR_LAUNCHES)]
    ob = ba.assemble(p, p.R, p.t, p.X, per_obs=True)
    assert ob.Wpl.shape == (4, 6, 3) and isinstance(ob, ba.ObsBlocks)
    y = ba.schur_lm_pass(p, ob.Wpl, torch.ones((2, 6)),
                         torch.eye(3).expand(3, 3, 3))
    ba.schur_kf_pass(p, ob.Wpl, y, a=torch.zeros((2, 6)))
    assert ba.LAUNCHES["plain"] == before[0]["plain"] + 1
    assert ba.SCHUR_LAUNCHES["plain"] == before[1]["plain"] + 2
    assert ba.LAUNCHES["kernel"] == before[0]["kernel"]
    assert ba.SCHUR_LAUNCHES["kernel"] == before[1]["kernel"]
