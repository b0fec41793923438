"""Helpers that hold a kernel against its plain version: the rows where
two runs of the two-camera match may rightly differ, the term
magnitudes that scale K17's rounding, and the packing of separately
computed pyramid levels into the one buffer K2's `orb_describe_levels`
takes. Used by `chip_smoke.py` and the tests; no pipeline path calls them.
"""
from __future__ import annotations

import torch

from .ops import hamming, stereo
from .optim import inertial


def general_margins(feats_l, feats_r, bear_l, bear_r, uv_l, uv_r, cam_l,
                    cam_r, R_rl, t_rl, sigma2, idx_a, idx_b, tol=1e-5):
    """Rows where two runs of the two-camera match may rightly differ: a
    pair that could be matched (octaves within 1, both valid, Hamming
    distance within TH_ORB) lies within `tol` of the epipolar gate in the
    row or in the column either run matched it to, or the row's chi2 lies
    within `tol` of its gate for either run's match. Returns (NL,) bool."""
    ep = stereo.epipolar_residual(bear_l, bear_r, R_rl, t_rl)
    oct_ok = torch.abs(feats_l.octave[:, None] - feats_r.octave[None, :]) <= 1
    near = (torch.abs(ep - stereo.EP_GATE) < tol) & oct_ok & \
        feats_l.valid[:, None] & feats_r.valid[None, :] & \
        (hamming.hamming_matrix(feats_l.desc, feats_r.desc) <= stereo.TH_ORB)
    row, col = near.any(dim=1), near.any(dim=0)
    out = row.clone()
    for idx in (idx_a, idx_b):
        j = torch.clamp(idx, min=0).long()
        _, _, e_l, e_r = stereo._triangulate_gate(
            bear_l, bear_r[j], uv_l, uv_r[j], R_rl, t_rl, sigma2, cam_l,
            cam_r, 5.991, 0.9998)
        margin = torch.minimum(torch.abs(e_l - 5.991), torch.abs(e_r - 5.991))
        out |= (idx >= 0) & (col[j] | (margin < tol))
    return out


def inertial_system_magnitudes(p: inertial.InitProblem, x):
    """`inertial.inertial_system_plain`'s sums over the absolute values of
    their terms: (H, g, cost) magnitudes, the scale of each entry's
    rounding."""
    r, J, W = inertial._edge_terms(p, x)
    return inertial._assemble(p, r.abs(), J.abs(), W.abs(), x.abs())


def plain_pyramid_blur(img, n_levels: int, scale: float):
    """The plain K6 (pyramid, then the blur of each level) in the layout
    the one-launch K6 returns: a stand-in for `image.pyramid_blur` that
    forces the plain K6 into `frontend.extract_orb`."""
    from .ops import image
    levels = image.build_pyramid_plain(img, n_levels, scale)
    return pack_levels(levels), pack_levels(
        [image.gaussian_blur_plain(l) for l in levels])


def pack_levels(levels):
    """The images `levels` copied into consecutive contiguous views of one
    buffer, the layout K6 returns and `orb_descriptor.orb_describe_levels`
    takes (for a plain K6 forced into `frontend.extract_orb`)."""
    buf = torch.cat([l.reshape(-1) for l in levels])
    parts = torch.split(buf, [l.numel() for l in levels])
    return [v.view(l.shape) for v, l in zip(parts, levels)]
