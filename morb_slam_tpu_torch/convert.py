"""Carry state between the port and plain numpy dicts.

`map_from_numpy` / `map_to_numpy` take a MapState to and from a dict of
numpy arrays keyed by field name (as `{k: np.asarray(v) for k, v in
m._asdict().items()}` builds from the reference package's map), so a map
captured from one tracker runs on in the other. `frame_*` do the same for
FrameData and Features, `camera_from_numpy` for camera parameters,
`rectify_from_numpy` for rectification maps, `settings_from_dict` for
the settings dataclasses (as `dataclasses.asdict` gives them),
`vocab_from_numpy` / `vocab_to_numpy` for vocabularies (a dict of centers,
weights and k, as `voc._asdict()` gives it) and `database_from_numpy` for
the keyframe database; `imu_from_numpy` / `imu_to_numpy` for the
inertial state types (ImuCalib, Preintegrated, KfImu, VIBAProblem,
PoseInertialResult: pass the type) and `tracker_imu_state` for a tracker's
bias, velocity and KfImu store; `pose_graph_from_numpy`, `pcg_carry_from_numpy`
and `stashed_from_numpy` / `stashed_to_numpy` for the pose graph, the PCG
solve's resumable carry (R, t, X, lam, cost) and a stashed map (map,
database, keyframe count, the merge's generation and offset).
Descriptors cross as the bit-identical int32 view of uint32 words; every
float array becomes float32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cameras, imu
from .frontend import Features
from .io import config
from .mapstate.atlas import StashedMap
from .mapstate.state import MapState
from .optim import inertial, pose_graph, vi_ba
from .ops.rectify import RectifyMaps
from .pipeline.tracking import FrameData
from .vocab import tree
from .vocab.database import KeyframeDatabase

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


def rectify_from_numpy(d, device="cpu") -> RectifyMaps:
    """RectifyMaps from a dict of map1, map2, R_rect1, baseline and cam_new
    as (kind, params)."""
    kind, params = d["cam_new"]
    return RectifyMaps(map1=_to_tensor(d["map1"], device),
                       map2=_to_tensor(d["map2"], device),
                       cam_new=camera_from_numpy(kind, params, device),
                       baseline=_to_tensor(d["baseline"], device),
                       R_rect1=_to_tensor(d["R_rect1"], device))


def settings_from_dict(d) -> config.Settings:
    """Settings from `dataclasses.asdict` of the reference's Settings."""
    d = dict(d)
    for k in ("cam1", "cam2"):
        if d.get(k) is not None:
            d[k] = config.CameraSettings(**d[k])
    if d.get("imu") is not None:
        d["imu"] = config.ImuSettings(**d["imu"])
    return config.Settings(**d)


def vocab_from_numpy(d, device="cpu") -> tree.Vocabulary:
    """Vocabulary from a dict of centers (per-level uint32 arrays), weights
    and k."""
    return tree.from_arrays([np.asarray(c) for c in d["centers"]],
                            np.asarray(d["weights"]), int(d["k"])).to(device)


def vocab_to_numpy(voc: tree.Vocabulary):
    centers, weights = tree.to_arrays(voc)
    return {"centers": centers, "weights": weights, "k": voc.k}


def database_from_numpy(d, device="cpu") -> KeyframeDatabase:
    return _from(KeyframeDatabase, d, device)


IMU_TYPES = {"ImuCalib": imu.ImuCalib, "Preintegrated": imu.Preintegrated,
             "KfImu": inertial.KfImu, "VIBAProblem": vi_ba.VIBAProblem,
             "PoseInertialResult": vi_ba.PoseInertialResult}


def imu_from_numpy(cls, d, device="cpu"):
    """An inertial state type (a class of IMU_TYPES, or its name) from a
    dict of numpy arrays keyed by field name (as `x._asdict()` of the
    reference package's NamedTuple gives it). Booleans stay bool."""
    cls = IMU_TYPES.get(cls, cls)
    out = {}
    for k in cls._fields:
        a = np.asarray(d[k])
        out[k] = torch.from_numpy(np.array(a, order="C")).to(device) \
            if a.dtype == np.bool_ else _to_tensor(a, device)
    return cls(**out)


def imu_to_numpy(x):
    return _to_numpy(x._asdict())


def tracker_imu_state(tr):
    """A tracker's inertial state as numpy: bias (6,), v_cur (3,) and the
    KfImu store's fields."""
    out = {"bias": tr.bias.detach().cpu().numpy(),
           "v_cur": tr.v_cur.detach().cpu().numpy()}
    if tr.kf_imu is not None:
        out["kf_imu"] = imu_to_numpy(tr.kf_imu)
    return out


def pose_graph_from_numpy(d, device="cpu") -> pose_graph.PoseGraph:
    """PoseGraph from a dict of its fields (fixed stays bool)."""
    return imu_from_numpy(pose_graph.PoseGraph, d, device)


def pcg_carry_from_numpy(carry, device="cpu"):
    """The PCG carry (R, t, X, lam, cost) from numpy arrays."""
    return tuple(_to_tensor(x, device) for x in carry)


def stashed_from_numpy(d, device="cpu") -> StashedMap:
    """StashedMap from a dict of gen, m (a map dict), n_kf, db (a database
    dict or None), merged_into_gen and kf_offset."""
    return StashedMap(
        gen=int(d["gen"]), m=map_from_numpy(d["m"], device),
        n_kf=int(d["n_kf"]),
        db=None if d.get("db") is None else database_from_numpy(d["db"],
                                                                device),
        merged_into_gen=int(d.get("merged_into_gen", -1)),
        kf_offset=int(d.get("kf_offset", 0)))


def stashed_to_numpy(st: StashedMap):
    return {"gen": st.gen, "m": map_to_numpy(st.m), "n_kf": st.n_kf,
            "db": None if st.db is None else _to_numpy(st.db._asdict()),
            "merged_into_gen": st.merged_into_gen,
            "kf_offset": st.kf_offset}
