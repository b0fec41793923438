"""The PyTorch port's live CLI, visual-inertial (mirrors
tests/test_aux.py's test_run_live_inertial_on_recorded_clip): 80 frames of
a rendered clip and an IMU CSV through `run_live --imu` on the CPU, each
frame taking the samples in (t_prev, t_frame].
"""
import numpy as np
import torch

from test_torch_aux import FX, H, K, W, _cam_yaml

torch.set_num_threads(1)


def test_run_live_inertial_on_recorded_clip(tmp_path):
    """run_live --imu: the visual-inertial live path on a recorded clip and
    an IMU CSV, each frame taking the samples in (t_prev, t_frame]."""
    import cv2
    from synthetic_world import PlaneWorld, analytic_pose, imu_between
    from morb_slam_tpu_torch.examples import run_live

    world = PlaneWorld(K, W, H, seed=0)
    video = str(tmp_path / "seq.avi")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 20.0,
                         (W, H), isColor=False)
    assert wr.isOpened()
    n_frames = 80
    rng = np.random.default_rng(1)
    prev_t = -0.05
    imu_lines = ["# ts,gx,gy,gz,ax,ay,az"]
    for i in range(n_frames):
        t = i * 0.05
        R, tc = analytic_pose(t)
        wr.write(np.clip(world.render(R.astype(np.float32),
                                      tc.astype(np.float32)),
                         0, 255).astype(np.uint8))
        ts_i, acc, gyr = imu_between(prev_t, t, rng=rng, noise_g=2.4e-3,
                                     noise_a=2.8e-2)
        for j in range(len(ts_i)):
            imu_lines.append(
                "%.6f,%.7f,%.7f,%.7f,%.7f,%.7f,%.7f"
                % (ts_i[j], gyr[j, 0], gyr[j, 1], gyr[j, 2],
                   acc[j, 0], acc[j, 1], acc[j, 2]))
        prev_t = t
    wr.release()
    imu_csv = str(tmp_path / "imu.csv")
    open(imu_csv, "w").write("\n".join(imu_lines) + "\n")
    yaml = tmp_path / "cam.yaml"
    _cam_yaml(yaml, "IMU.NoiseGyro: 1.7e-4\nIMU.NoiseAcc: 2.0e-3\n"
                    "IMU.GyroWalk: 1.9e-5\nIMU.AccWalk: 3.0e-3\n"
                    "IMU.Frequency: 200.0\n")
    traj = str(tmp_path / "traj.txt")
    rc = run_live.main(["--source", video, "--settings", str(yaml),
                        "--imu", imu_csv, "--traj", traj,
                        "--max-frames", str(n_frames),
                        "--max-kf", "64", "--max-lm", "8000",
                        "--device", "cpu"])
    assert rc == 0
    lines = open(traj).readlines()
    assert len(lines) > 40, len(lines)
