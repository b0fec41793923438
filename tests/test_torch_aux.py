"""The PyTorch port's auxiliary modules (mirrors tests/test_aux.py): stage
timers, leveled logging, the headless map dumps, the IMU noise tool, the
dataset CLI on a synthetic EuRoC-layout sequence, the live CLI on a video
file and a deterministic replay of the tracker, all on the CPU (the live
CLI's visual-inertial run is in test_torch_aux_inertial.py). For the same
inputs, the map dumps, the keypoint raster and the IMU noise estimate
equal the JAX package's.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import viz as j_viz
from morb_slam_tpu.mapstate import state as j_ms
from morb_slam_tpu.tools import process_imu as j_process_imu
from morb_slam_tpu_torch import convert, viz
from morb_slam_tpu_torch.mapstate import state as ms
from morb_slam_tpu_torch.tools import process_imu
from morb_slam_tpu_torch.utils import profiling, verbose

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])


def test_stage_timers():
    t = profiling.StageTimers(enabled=True)
    with t.stage("TrackTotal"):
        sum(range(1000))
    t.add_ms("LMTotal", 3.5)
    t.add_ms("LMTotal", 4.5)
    st = t.stats()
    assert st["LMTotal"][0] == 2
    assert abs(st["LMTotal"][1] - 4.0) < 1e-9
    assert "TrackTotal" in t.report()


def test_stage_timers_disabled_noop():
    t = profiling.StageTimers(enabled=False)
    with t.stage("X"):
        pass
    assert not t.samples


def test_timers_save(tmp_path):
    t = profiling.StageTimers(enabled=True)
    t.add_ms("ORBExtract", 1.0)
    p = str(tmp_path / "ExecTimeMean.txt")
    t.save(p)
    assert "ORBExtract" in open(p).read()


def test_verbose_levels(capsys):
    verbose.set_level(verbose.Level.QUIET)
    verbose.print_mess("hidden", verbose.Level.NORMAL)
    verbose.set_level(verbose.Level.NORMAL)
    verbose.print_mess("shown", verbose.Level.NORMAL)
    err = capsys.readouterr().err
    assert "shown" in err and "hidden" not in err


def test_viz_dumps(tmp_path):
    m = ms.empty_map(4, 8, 64)
    rng = np.random.default_rng(0)
    pos = m.lm_pos.clone()
    pos[:10] = torch.tensor(rng.uniform(-1, 1, (10, 3)), dtype=torch.float32)
    valid = m.lm_valid.clone()
    valid[:10] = True
    kf_valid = m.kf_valid.clone()
    kf_valid[:2] = True
    m = m._replace(kf_valid=kf_valid, lm_pos=pos, lm_valid=valid)
    jm = j_ms.MapState(**{k: jnp.asarray(v) for k, v in
                          convert.map_to_numpy(m).items()})
    traj = np.zeros((5, 3))
    paths = {}
    for name, mod, mm in (("port", viz, m), ("jax", j_viz, jm)):
        paths[name] = (str(tmp_path / f"{name}.ply"),
                       str(tmp_path / f"{name}.svg"))
        mod.write_ply(paths[name][0], mm)
        mod.write_svg(paths[name][1], mm, trajectory_xyz=traj)
    txt = open(paths["port"][0]).read()
    assert "element vertex" in txt and "element edge" in txt
    assert "<svg" in open(paths["port"][1]).read()
    for a, b in zip(paths["port"], paths["jax"]):
        assert open(a).read() == open(b).read()

    img = np.zeros((64, 64), np.float32)
    args = (np.asarray([[10, 10], [60, 60]]), np.asarray([True, True]),
            np.asarray([True, False]))
    rgb = viz.frame_overlay(torch.from_numpy(img), *map(torch.from_numpy,
                                                        args))
    assert rgb.shape == (64, 64, 3)
    assert rgb[8, 8, 1] == 255          # green box corner at (10,10)
    np.testing.assert_array_equal(rgb, j_viz.frame_overlay(img, *args))


def test_process_imu_noise_estimate(tmp_path):
    rng = np.random.default_rng(0)
    fs, dur = 200.0, 120.0
    n = int(fs * dur)
    ts = np.arange(n) / fs
    sigma_g = 1.7e-4 * np.sqrt(fs)   # white noise with density 1.7e-4
    gyro = rng.normal(0, sigma_g, (n, 3))
    acc = rng.normal(0, 2e-3 * np.sqrt(fs), (n, 3)) + [0, 0, 9.81]
    out = process_imu.estimate_noise(ts, gyro, acc)
    assert 0.5 * 1.7e-4 < out["gyro_noise_density"] < 2 * 1.7e-4, out
    assert abs(out["frequency_hz"] - fs) < 1.0
    assert out == j_process_imu.estimate_noise(ts, gyro, acc)
    # the CSV reader too: EuRoC rows in nanoseconds
    p = str(tmp_path / "imu.csv")
    rows = ["#timestamp [ns],wx,wy,wz,ax,ay,az"] + [
        f"{int(t * 1e9)},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}"
        for t, g, a in zip(ts[:500], gyro, acc)]
    open(p, "w").write("\n".join(rows) + "\n")
    for x, y in zip(process_imu.load_imu_csv(p),
                    j_process_imu.load_imu_csv(p)):
        np.testing.assert_array_equal(x, y)


def _make_euroc_mini(root, world, seq, fps=10.0):
    """Write a tiny EuRoC-layout dataset from the synthetic world."""
    import cv2
    cam0 = os.path.join(root, "mav0", "cam0")
    os.makedirs(os.path.join(cam0, "data"), exist_ok=True)
    rows = []
    for i, (R, t) in enumerate(seq):
        ts_ns = int(i / fps * 1e9)
        name = f"{ts_ns}.png"
        img = world.render(R, t).astype(np.uint8)
        cv2.imwrite(os.path.join(cam0, "data", name), img)
        rows.append(f"{ts_ns},{name}")
    with open(os.path.join(cam0, "data.csv"), "w") as f:
        f.write("#ts,filename\n" + "\n".join(rows) + "\n")


def test_run_dataset_cli_mono(tmp_path):
    """The whole CLI: a synthetic EuRoC-layout mono sequence -> trajectory,
    map dumps and the summary JSON."""
    pytest.importorskip("cv2")
    from synthetic_world import PlaneWorld, camera_path
    from morb_slam_tpu_torch.examples import run_dataset

    world = PlaneWorld(K, W, H, seed=0)
    seq = camera_path(12, step=0.05)
    root = str(tmp_path / "seq")
    _make_euroc_mini(root, world, seq)

    yaml_path = str(tmp_path / "settings.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"""%YAML:1.0
---
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {FX}
Camera1.fy: {FX}
Camera1.cx: {W / 2}
Camera1.cy: {H / 2}
Camera.width: {W}
Camera.height: {H}
Camera.fps: 10
ORBextractor.nFeatures: 400
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
""")
    traj = str(tmp_path / "traj.txt")
    ply = str(tmp_path / "map.ply")
    svg = str(tmp_path / "map.svg")
    rc = run_dataset.main([
        "--dataset", "euroc", "--sensor", "mono", "--root", root,
        "--settings", yaml_path, "--traj", traj, "--map-ply", ply,
        "--map-svg", svg, "--max-kf", "32", "--max-lm", "4000",
        "--device", "cpu",
    ])
    assert rc == 0
    assert os.path.exists(traj) and len(open(traj).read().strip()) > 0
    assert os.path.exists(ply) and os.path.exists(svg)


def _cam_yaml(path, extra=""):
    path.write_text(
        'File.version: "1.0"\n'
        "Camera.type: PinHole\n"
        f"Camera1.fx: {FX}\nCamera1.fy: {FX}\n"
        f"Camera1.cx: {W / 2}\nCamera1.cy: {H / 2}\n"
        f"Camera.width: {W}\nCamera.height: {H}\n"
        "Camera.fps: 20\n" + extra +
        "ORBextractor.nFeatures: 500\n"
        "ORBextractor.nLevels: 4\n")


def test_run_live_on_video_file(tmp_path):
    """The live CLI on a rendered video file through cv2.VideoCapture, the
    path a V4L2 device or an RTSP stream takes."""
    import cv2
    from synthetic_world import PlaneWorld, camera_path
    from morb_slam_tpu_torch.examples import run_live

    world = PlaneWorld(K, W, H, seed=0)
    video = str(tmp_path / "seq.avi")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 20.0,
                         (W, H), isColor=False)
    assert wr.isOpened()
    for R, t in camera_path(40, step=0.05):
        wr.write(np.clip(world.render(R, t), 0, 255).astype(np.uint8))
    wr.release()
    yaml = tmp_path / "cam.yaml"
    _cam_yaml(yaml)
    traj = str(tmp_path / "traj.txt")
    rc = run_live.main(["--source", video, "--settings", str(yaml),
                        "--traj", traj, "--max-frames", "40",
                        "--max-kf", "32", "--max-lm", "6000",
                        "--device", "cpu"])
    assert rc == 0
    lines = open(traj).readlines()
    assert len(lines) > 20, len(lines)


def test_deterministic_replay():
    """Two identical runs of the tracker give bit-identical trajectories
    and maps: no unseeded draw, host clock or iteration order leaks into a
    decision."""
    from synthetic_world import PlaneWorld, camera_path
    from morb_slam_tpu_torch import cameras
    from morb_slam_tpu_torch.pipeline import tracking

    world = PlaneWorld(K, W, H, seed=0)
    poses = camera_path(35, step=0.05)
    frames = [world.render(R, t) for R, t in poses]

    def run():
        cfg = tracking.TrackerConfig(width=W, height=H, focal=FX,
                                     n_feat=500, max_kf=32, max_lm=6000,
                                     n_levels=4, min_init_matches=60,
                                     min_init_points=40)
        tr = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                              device="cpu")
        for i, img in enumerate(frames):
            tr.track_mono(img, ts=float(i))
        tr.flush()
        traj = np.asarray([p for _, p in tr.trajectory_world()])
        return traj, tr.m.lm_pos.numpy(), tr.m.kf_t.numpy()

    t1, lm1, kt1 = run()
    t2, lm2, kt2 = run()
    assert len(t1) > 30
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(lm1, lm2)
    np.testing.assert_array_equal(kt1, kt2)
