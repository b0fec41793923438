"""Isolation and device rules of the PyTorch port: it imports neither JAX
nor the JAX package, nor YAML or OpenCV at import time (the card's machine
has neither); its tracker and System refuse to run without a card unless
asked for the CPU; and its kernel wrappers never fall back to the plain
versions for a tensor that is not on the CPU. The walk over the package
covers every module, among them `vocab/`, `io/serialization.py`,
`solvers/pnp.py`, `imu.py`, `optim/inertial.py`, `optim/vi_ba.py` and the
loop-closing slice's `solvers/sim3.py`, `optim/pose_graph.py`,
`mapstate/atlas.py`, `pipeline/global_ba.py` and
`pipeline/loop_closing.py`, and the persistence and CLI slice's
`io/trajectory.py`, `io/datasets.py`, `io/native_loader.py`,
`eval/ate.py`, `utils/`, `viz.py`, `examples/` and `tools/`; K13's
wrapper (`optim/vi_ba.py` inertial_terms, with and without the system),
K15's
(`optim/pose_graph.py` normal_equations), K6's (`ops/image.py`
pyramid_blur, build_pyramid, blur_levels), K3's gated mode
(`ops/hamming.py` hamming_top2_gated) and K19's (`ops/hamming.py`
hamming_matrix_mxu) are held to the same device rules, and the
multi-device slice's mesh (`parallel/distributed.py` global_obs_mesh)
defaults to the card. The native
image loader builds only from the port's own
`morb_slam_tpu_torch/native/loader.cc` and reads nothing of the repository's
`native/` directory."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import cameras, frontend, imu, system
from morb_slam_tpu_torch.io import config
from morb_slam_tpu_torch.ops import (fast, hamming, image, orb_descriptor,
                                     rectify, stereo)
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
                     "pipeline.global_ba", "pipeline.loop_closing",
                     "io.trajectory", "io.datasets", "io.native_loader",
                     "eval.ate", "utils.profiling", "utils.verbose", "viz",
                     "examples.run_dataset", "examples.run_live",
                     "tools.process_imu", "parallel.sharded_ba",
                     "parallel.distributed"):
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


def test_ate_default_device_needs_cuda(monkeypatch, tmp_path):
    """eval.ate aligns on the card unless the caller asks for the CPU."""
    from morb_slam_tpu_torch.eval import ate
    from morb_slam_tpu_torch.io import trajectory
    poses = [(0.1 * i, np.eye(3), np.array([0.1 * i, 0.02 * i * i, 0.0]))
             for i in range(5)]
    path = str(tmp_path / "t.txt")
    trajectory.write_tum(path, poses)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ate.evaluate(path, path)
    assert ate.evaluate(path, path, device="cpu")["pairs"] == 5


def _counts():
    return [dict(c) for c in (fast.LAUNCHES, orb_descriptor.LAUNCHES,
                              hamming.LAUNCHES, stereo.LAUNCHES,
                              rectify.LAUNCHES, pose_opt.LAUNCHES,
                              tree.LAUNCHES["vocab_transform"],
                              tree.LAUNCHES["bow_l1"], ba.LAUNCHES,
                              imu.LAUNCHES, vi_ba.LAUNCHES,
                              ba.SCHUR_LAUNCHES, vi_ba.INERTIAL_LAUNCHES,
                              pose_graph.LAUNCHES, image.LAUNCHES,
                              hamming.MXU_LAUNCHES)]


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
                                    "normal_equations", "build_pyramid",
                                    "blur_levels", "orb_describe_levels",
                                    "fast_select_levels", "pyramid_blur",
                                    "hamming_top2_gated", "hamming_mxu"])
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
            vi_ba.inertial_terms(p, *st, Hpp, bp)
        elif kernel == "inertial_cost":
            p, st, Hpp, bp = _vi_args(meta)
            vi_ba.inertial_terms(p, *st, Hpp, bp, system=False)
        elif kernel == "normal_equations":
            pose_graph.normal_equations(*_graph_args(meta))
        elif kernel == "build_pyramid":
            image.build_pyramid(torch.empty((48, 64), device=meta), 3, 1.2)
        elif kernel == "blur_levels":
            image.blur_levels([torch.empty((48, 64), device=meta),
                               torch.empty((40, 53), device=meta)])
        elif kernel == "pyramid_blur":
            image.pyramid_blur(torch.empty((48, 64), device=meta), 3, 1.2)
        elif kernel == "hamming_top2_gated":
            d = torch.empty((4, 8), dtype=torch.int32, device=meta)
            uv = torch.zeros((4, 2), device=meta)
            o = torch.zeros(4, dtype=torch.int32, device=meta)
            f = torch.ones(4, dtype=torch.bool, device=meta)
            hamming.hamming_top2_gated(d, d, uv, uv[:, 0], o, f, uv, o, f,
                                       "window")
        elif kernel == "hamming_mxu":
            d = torch.empty((4, 8), dtype=torch.int32, device=meta)
            hamming.hamming_matrix_mxu(d, d[:3])
        elif kernel == "fast_select_levels":
            fast.fast_select_levels([torch.empty((48, 64), device=meta)],
                                    [10], frontend.OrbConfig())
        elif kernel == "orb_describe_levels":
            img = torch.empty((48, 64), device=meta)
            orb_descriptor.orb_describe_levels([img], [img], [torch.zeros(
                (4, 2), dtype=torch.int32, device=meta)])
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
    H, b, c = vi_ba.inertial_terms(p, *st, Hpp, bp)
    assert H.shape == (30, 30) and b.shape == (30,) and c.dim() == 0
    H, b, c = pose_graph.normal_equations(*_graph_args("cpu"))
    assert H.shape == (21, 21) and b.shape == (21,) and c.dim() == 0
    levels = image.build_pyramid(img, 3, 1.2)
    assert [tuple(l.shape) for l in levels] == [(48, 64), (40, 53), (33, 44)]
    assert hamming.hamming_matrix_mxu(d, d[:2]).tolist() == [[0, 0]] * 3
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


def test_gated_k3_uses_plain_version_on_cpu():
    """K3's gated mode on CPU tensors: its plain version (the dense gate,
    then hamming_top2_plain), one plain call and no launch."""
    d = torch.zeros((3, 8), dtype=torch.int32)
    uv = torch.zeros((3, 2))
    o = torch.zeros(3, dtype=torch.int32)
    f = torch.ones(3, dtype=torch.bool)
    before = dict(hamming.LAUNCHES)
    best, idx, second = hamming.hamming_top2_gated(d, d, uv, uv[:, 0] + 1.0,
                                                   o, f, uv, o, f, "window")
    assert hamming.LAUNCHES == {"kernel": before["kernel"],
                                "plain": before["plain"] + 1}
    assert best.tolist() == [0, 0, 0] and idx.tolist() == [0, 0, 0]
    assert second.tolist() == [0, 0, 0]


def test_k6_blur_uses_plain_version_on_cpu():
    """blur_levels on CPU tensors: the plain blur once per level, equal to
    gaussian_blur_plain of each level."""
    img = torch.rand((48, 64)) * 255
    levels = image.build_pyramid_plain(img, 3, 1.2)
    before = dict(image.LAUNCHES)
    out = image.blur_levels(levels)
    assert image.LAUNCHES == {"kernel": before["kernel"],
                              "plain": before["plain"] + 3}
    for o, l in zip(out, levels):
        assert torch.equal(o, image.gaussian_blur_plain(l))


def test_global_obs_mesh_defaults_to_cuda():
    """The multi-device slice's mesh is a card mesh unless the caller asks
    for the CPU: without a card the default refuses before any process
    group is made."""
    import inspect
    import torch.distributed as dist
    from morb_slam_tpu_torch.parallel import distributed
    sig = inspect.signature(distributed.global_obs_mesh)
    assert sig.parameters["device_type"].default == "cuda"
    assert inspect.signature(distributed.initialize).parameters[
        "device_type"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.global_obs_mesh()
    assert not dist.is_initialized()


def test_native_loader_builds_from_the_ports_source(tmp_path):
    """A fresh build of the image loader compiles the port's own
    native/loader.cc into the given build directory and loads that library:
    no path under the repository's native/ directory is compiled, linked or
    loaded."""
    script = textwrap.dedent(f"""
        import ctypes, os, subprocess
        from morb_slam_tpu_torch.io import native_loader as nl
        seen = []
        run, cdll = subprocess.run, ctypes.CDLL
        def spy_run(cmd, *a, **k):
            seen.extend(cmd)
            return run(cmd, *a, **k)
        def spy_cdll(name, *a, **k):
            seen.append(name)
            return cdll(name, *a, **k)
        subprocess.run, ctypes.CDLL = spy_run, spy_cdll
        nl.BUILD_DIR = {str(tmp_path)!r}
        assert nl.get_lib() is not None, nl.build_error()
        native = os.path.join({REPO!r}, "native") + os.sep
        assert nl.SRC in seen, seen
        assert not [p for p in seen if str(p).startswith(native)], seen
        assert any(str(p).startswith({str(tmp_path)!r}) for p in seen), seen
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
