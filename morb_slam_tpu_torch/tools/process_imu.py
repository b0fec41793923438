"""IMU calibration data prep and noise estimation (counterpart of
`morb_slam_tpu/tools/process_imu.py`, numpy only): reads EuRoC-format IMU
CSVs, takes a static segment and estimates the white-noise densities and
bias random walks of the IMU.Noise{Gyro,Acc} / IMU.{Gyro,Acc}Walk settings
keys from the Allan deviation, vectorized over averaging windows.

Usage:
  python -m morb_slam_tpu_torch.tools.process_imu data.csv \
      [--static-start 0 --static-end 30]
"""
from __future__ import annotations

import argparse
import csv
import json

import numpy as np


def load_imu_csv(path: str):
    """EuRoC imu0/data.csv: ts[ns], gyro xyz [rad/s], acc xyz [m/s^2]."""
    ts, gyro, acc = [], [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(int(row[0]) * 1e-9)
            gyro.append([float(x) for x in row[1:4]])
            acc.append([float(x) for x in row[4:7]])
    return (np.asarray(ts), np.asarray(gyro, np.float64),
            np.asarray(acc, np.float64))


def allan_deviation(x: np.ndarray, fs: float, n_taus: int = 40):
    """Overlapping Allan deviation of a rate signal x (N, d).

    Returns (taus (T,), adev (T, d)). Vectorized over averaging windows via
    cumulative sums (theta = integral of x)."""
    N = x.shape[0]
    theta = np.cumsum(x, axis=0) / fs                     # integrated signal
    max_m = N // 3
    ms = np.unique(np.logspace(0, np.log10(max(max_m, 2)),
                               n_taus).astype(int))
    ms = ms[ms >= 1]
    taus = ms / fs
    out = np.empty((len(ms), x.shape[1]))
    for i, m in enumerate(ms):
        d = theta[2 * m:] - 2 * theta[m:-m] + theta[:-2 * m]
        out[i] = np.sqrt(np.mean(d * d, axis=0) / (2 * (m / fs) ** 2))
    return taus, out


def estimate_noise(ts, gyro, acc, t0=None, t1=None):
    """Noise densities from a static segment.

    White-noise density N: Allan deviation at tau=1s (slope -1/2 region).
    Random walk K: Allan deviation at large tau (slope +1/2), scaled by
    sqrt(3/tau). Falls back to total-range anchors when the segment is
    short."""
    mask = np.ones(len(ts), bool)
    if t0 is not None:
        mask &= ts >= ts[0] + t0
    if t1 is not None:
        mask &= ts <= ts[0] + t1
    ts_s, gy, ac = ts[mask], gyro[mask], acc[mask]
    if len(ts_s) < 100:
        raise ValueError("static segment too short")
    fs = 1.0 / np.median(np.diff(ts_s))
    ac = ac - ac.mean(axis=0)        # gravity + accel bias out

    result = {}
    for name, sig in (("gyro", gy - gy.mean(axis=0)), ("acc", ac)):
        taus, adev = allan_deviation(sig, fs)
        a = np.mean(adev, axis=1)    # average the three axes
        i1 = int(np.argmin(np.abs(taus - 1.0)))
        noise_density = float(a[i1] * np.sqrt(taus[i1]))
        i_rw = int(np.argmin(a))     # bias-instability floor; walk beyond
        tau_rw = taus[min(i_rw + 3, len(taus) - 1)]
        walk = float(a[min(i_rw + 3, len(taus) - 1)] * np.sqrt(3.0 / tau_rw))
        result[f"{name}_noise_density"] = noise_density
        result[f"{name}_walk"] = walk
    result["frequency_hz"] = float(fs)
    result["n_samples"] = int(len(ts_s))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("csv", help="EuRoC-format IMU CSV")
    ap.add_argument("--static-start", type=float, default=None,
                    help="static segment start (s, relative)")
    ap.add_argument("--static-end", type=float, default=None)
    args = ap.parse_args(argv)
    ts, gyro, acc = load_imu_csv(args.csv)
    out = estimate_noise(ts, gyro, acc, args.static_start, args.static_end)
    print(json.dumps(out, indent=2))
    print("\n# settings keys (paste into the YAML):")
    print(f"IMU.NoiseGyro: {out['gyro_noise_density']:.6e}")
    print(f"IMU.NoiseAcc: {out['acc_noise_density']:.6e}")
    print(f"IMU.GyroWalk: {out['gyro_walk']:.6e}")
    print(f"IMU.AccWalk: {out['acc_walk']:.6e}")
    print(f"IMU.Frequency: {out['frequency_hz']:.1f}")


if __name__ == "__main__":
    main()
