"""Carry state between the port and plain numpy dicts.

`map_from_numpy` / `map_to_numpy` take a MapState to and from a dict of
numpy arrays keyed by field name (as `{k: np.asarray(v) for k, v in
m._asdict().items()}` builds from the reference package's map), so a map
captured from one tracker runs on in the other. `frame_*` do the same for
FrameData and Features, `camera_from_numpy` for camera parameters.
Descriptors cross as the bit-identical int32 view of uint32 words; every
float array becomes float32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cameras
from .frontend import Features
from .mapstate.state import MapState
from .pipeline.tracking import FrameData

_DESC_FIELDS = ("desc", "kf_feat_desc", "lm_desc")


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu" and a.dtype != np.int32:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _to_numpy(fields):
    """dict of numpy arrays; descriptor words back to uint32."""
    out = {}
    for k, v in fields.items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in _DESC_FIELDS else a
    return out


def _from(cls, d, device):
    return cls(**{k: _to_tensor(d[k], device) for k in cls._fields})


def map_from_numpy(d, device="cpu") -> MapState:
    return _from(MapState, d, device)


def map_to_numpy(m: MapState):
    return _to_numpy(m._asdict())


def frame_from_numpy(d, device="cpu"):
    """FrameData from a dict with its fields, or Features from one with
    Features' fields."""
    cls = FrameData if "xn" in d else Features
    return _from(cls, d, device)


def frame_to_numpy(fr):
    return _to_numpy(fr._asdict())


def camera_from_numpy(kind: int, params, device="cpu") -> cameras.Camera:
    return cameras.Camera(int(kind), torch.as_tensor(
        np.asarray(params, np.float32), device=device))
