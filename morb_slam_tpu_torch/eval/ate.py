"""ATE evaluation CLI (counterpart of `morb_slam_tpu/eval/ate.py`):
associate two trajectories by timestamp, align them (Horn / Umeyama,
optionally with scale) and report the RMS absolute trajectory error.

Usage: python -m morb_slam_tpu_torch.eval.ate gt.txt est.txt [--scale]
       [--device cpu|cuda]
"""
from __future__ import annotations

import argparse

import torch

from .. import alignment
from ..io import trajectory
from ..pipeline.tracking import resolve_device


def evaluate(gt_path: str, est_path: str, with_scale: bool = False,
             max_dt: float = 0.02, device=None):
    """The alignment runs on `device` (default: the card)."""
    device = resolve_device(device)
    ts_g, pos_g, _ = trajectory.read_tum(gt_path)
    ts_e, pos_e, _ = trajectory.read_tum(est_path)
    ia, ib = trajectory.associate(ts_g, ts_e, max_dt=max_dt)
    if len(ia) < 2:
        raise ValueError(f"only {len(ia)} associated pairs")
    rmse, s, _, _ = alignment.ate_rmse(
        torch.tensor(pos_e[ib], dtype=torch.float32, device=device),
        torch.tensor(pos_g[ia], dtype=torch.float32, device=device),
        with_scale=with_scale)
    return {"rmse": float(rmse), "scale": float(s), "pairs": int(len(ia))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("gt")
    ap.add_argument("est")
    ap.add_argument("--scale", action="store_true",
                    help="estimate scale (monocular)")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu to run "
                         "there)")
    args = ap.parse_args(argv)
    out = evaluate(args.gt, args.est, with_scale=args.scale,
                   max_dt=args.max_dt, device=args.device)
    print(f"compared_pose_pairs {out['pairs']} pairs")
    print(f"absolute_translational_error.rmse {out['rmse']:.6f} m")
    print(f"scale: {out['scale']:.6f}")


if __name__ == "__main__":
    main()
