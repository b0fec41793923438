"""Vocabulary files, map checkpoints and whole-Atlas checkpoints
(counterpart of `morb_slam_tpu/io/serialization.py`).

The file formats are the reference package's, so a file written by either
package loads in the other:

- a vocabulary is a `.npz` of `k`, `depth`, `weights` and `centers_<l>`
  (uint32 words), or the DBoW2 / ORBvoc text format for paths ending in
  `.txt`;
- a map is `<path>.npz` (one array per `MapState` field) and `<path>.json`
  (format version, field names, metadata, the vocabulary's MD5);
- an Atlas is one `<path>.npz` of the active map (`active.*`), its inertial
  store (`active_imu.*`), every stashed map with its store and database
  (`stash{i}.*`, `stash{i}_imu.*`, `stash{i}_db.bow/valid`), the frame
  trajectory (`traj.*`) and the tracker's bias (`tracker.bias`), plus one
  `<path>.json` manifest of the counters and the stash entries.

Descriptors go to disk as uint32 words, as the reference writes them; the
port holds them as the bit-identical int32 view. Every float field is
float32, every index int32, every mask bool, as in the reference.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from ..mapstate import state as ms
from ..mapstate.atlas import StashedMap
from ..optim.inertial import KfImu
from ..vocab import database as kfdb
from ..vocab import tree

FORMAT_VERSION = 1
ATLAS_VERSION = 1
_DESC_FIELDS = ("kf_feat_desc", "lm_desc")


def save_vocabulary(path: str, voc: tree.Vocabulary):
    centers, weights = tree.to_arrays(voc)
    np.savez_compressed(
        path, k=voc.k, depth=voc.depth, weights=weights,
        **{f"centers_{i}": c for i, c in enumerate(centers)})


def load_vocabulary(path: str) -> tree.Vocabulary:
    """A vocabulary of CPU tensors from a `.npz` or an ORBvoc `.txt`."""
    if path.endswith(".txt"):
        return tree.load_orbvoc_text(path)
    d = np.load(path)
    depth = int(d["depth"])
    return tree.from_arrays([d[f"centers_{i}"] for i in range(depth)],
                            d["weights"], int(d["k"]))


def vocab_checksum(voc: tree.Vocabulary) -> str:
    """MD5 over the uint32 centers of every level, then the float32
    weights: the reference package's digest of the same vocabulary."""
    h = hashlib.md5()
    centers, weights = tree.to_arrays(voc)
    for c in centers:
        h.update(np.ascontiguousarray(c).tobytes())
    h.update(np.ascontiguousarray(weights).tobytes())
    return h.hexdigest()


def _to_numpy(fields: dict, prefix: str = "") -> dict:
    """{prefix + name: numpy array}, descriptor words as uint32."""
    out = {}
    for k, v in fields.items():
        a = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        out[prefix + k] = a.view(np.uint32) if k in _DESC_FIELDS else a
    return out


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu" and a.dtype != np.int32:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _check_vocab(info: dict, voc):
    if voc is not None and "vocab_md5" in info and \
            vocab_checksum(voc) != info["vocab_md5"]:
        raise ValueError("vocabulary checksum mismatch: this map was built "
                         "with a different vocabulary")


def _write_json(path: str, info: dict, meta, voc):
    if meta:
        info["meta"] = meta
    if voc is not None:
        info["vocab_md5"] = vocab_checksum(voc)
    with open(path + ".json", "w") as f:
        json.dump(info, f, indent=1)


def save_map(path: str, m: ms.MapState, meta: dict | None = None,
             voc=None):
    """Write <path>.npz + <path>.json."""
    np.savez_compressed(path + ".npz", **_to_numpy(m._asdict()))
    _write_json(path, {"format_version": FORMAT_VERSION,
                       "fields": list(m._fields)}, meta, voc)


def load_map(path: str, voc=None, device="cpu") -> ms.MapState:
    """Load a map onto `device`; with a vocabulary, refuse a map whose
    recorded vocabulary checksum differs (its descriptors would be
    meaningless)."""
    with open(path + ".json") as f:
        info = json.load(f)
    if info["format_version"] != FORMAT_VERSION:
        raise ValueError(f"map format {info['format_version']} != "
                         f"{FORMAT_VERSION}")
    _check_vocab(info, voc)
    data = np.load(path + ".npz")
    return ms.MapState(**{k: _to_tensor(data[k], device)
                          for k in info["fields"]})


def save_atlas(path: str, tracker, meta: dict | None = None, voc=None):
    """Write the whole multi-map state: the active map, every stashed map
    (with its database and inertial store), the tracker's inertial store,
    the frame trajectory and the session counters."""
    tracker.flush()
    arrays = _to_numpy(tracker.m._asdict(), "active.")
    if tracker.kf_imu is not None:
        arrays.update(_to_numpy(tracker.kf_imu._asdict(), "active_imu."))
    stash_meta = []
    for i, st in enumerate(tracker.stash):
        arrays.update(_to_numpy(st.m._asdict(), f"stash{i}."))
        if st.kf_imu is not None:
            arrays.update(_to_numpy(st.kf_imu._asdict(), f"stash{i}_imu."))
        if st.db is not None:
            arrays.update(_to_numpy(st.db._asdict(), f"stash{i}_db."))
        stash_meta.append({"gen": st.gen, "n_kf": st.n_kf,
                           "merged_into_gen": st.merged_into_gen,
                           "kf_offset": st.kf_offset,
                           "has_imu": st.kf_imu is not None,
                           "has_db": st.db is not None})
    traj = tracker.trajectory
    if traj:
        # trajectory entries are poses relative to a (generation, keyframe)
        # anchor; one copy to the host for all of them
        arrays["traj.ts"] = np.asarray([e[0] for e in traj], np.float64)
        arrays["traj.gen"] = np.asarray([e[1] for e in traj], np.int32)
        arrays["traj.ref"] = np.asarray([int(e[2]) for e in traj], np.int32)
        arrays["traj.R"] = torch.stack([e[3] for e in traj]).cpu().numpy()
        arrays["traj.t"] = torch.stack([e[4] for e in traj]).cpu().numpy()
    arrays["tracker.bias"] = tracker.bias.cpu().numpy()
    np.savez_compressed(path + ".npz", **arrays)
    ts_first = tracker.ts_first_kf
    _write_json(path, {
        "format_version": FORMAT_VERSION, "atlas_version": ATLAS_VERSION,
        "fields": list(tracker.m._fields), "stash": stash_meta,
        "map_gen": tracker.map_gen, "n_kf_host": tracker.n_kf_host,
        "n_traj": len(traj), "imu_ready": bool(tracker.imu_ready),
        "viba_stage": int(tracker.viba_stage),
        "ts_first_kf": None if ts_first is None else float(ts_first),
        "has_imu": tracker.kf_imu is not None}, meta, voc)


def rebuild_database(tracker, voc, n_kf: int):
    """The active map's place-recognition database from its keyframes'
    descriptors (derived state, not stored): K9 `transform`, the BoW
    vector and `add_keyframe` per valid keyframe below n_kf."""
    m = tracker.m
    tracker.db = kfdb.empty(m.kf_valid.shape[0], voc.n_words,
                            device=tracker.device)
    valid = m.kf_valid.cpu().numpy()
    for k in range(min(n_kf, len(valid))):
        if valid[k]:
            bow = tree.bow_vector(voc, tree.transform(
                voc, m.kf_feat_desc[k], m.kf_feat_valid[k]))
            tracker.db = kfdb.add_keyframe(tracker.db, k, bow)


def load_atlas(path: str, tracker, voc=None):
    """Restore a whole Atlas into `tracker`, on the tracker's device: the
    maps, stores, databases, trajectory and counters; the active map's
    database is rebuilt, and the session resumes RECENTLY_LOST, to
    relocalize into the restored map. Raises ValueError for a file that is
    not an Atlas checkpoint or a vocabulary whose checksum differs."""
    with open(path + ".json") as f:
        info = json.load(f)
    if info.get("atlas_version") != ATLAS_VERSION:
        raise ValueError("not an atlas checkpoint (use load_map)")
    _check_vocab(info, voc)
    data = np.load(path + ".npz")
    dev = tracker.device

    def get(prefix, cls):
        return cls(**{k: _to_tensor(data[prefix + k], dev)
                      for k in cls._fields})

    tracker.m = get("active.", ms.MapState)
    if info.get("has_imu") and tracker.kf_imu is not None:
        tracker.kf_imu = get("active_imu.", KfImu)
    tracker.stash = []
    for i, se in enumerate(info["stash"]):
        tracker.stash.append(StashedMap(
            gen=se["gen"], m=get(f"stash{i}.", ms.MapState), n_kf=se["n_kf"],
            db=get(f"stash{i}_db.", kfdb.KeyframeDatabase)
            if se["has_db"] else None,
            kf_imu=get(f"stash{i}_imu.", KfImu) if se["has_imu"] else None,
            merged_into_gen=se["merged_into_gen"],
            kf_offset=se["kf_offset"]))
    tracker.trajectory = []
    if info["n_traj"]:
        Rs = _to_tensor(data["traj.R"], dev)
        ts_ = _to_tensor(data["traj.t"], dev)
        tracker.trajectory = [
            (float(ts), int(gen), int(ref), Rs[i], ts_[i])
            for i, (ts, gen, ref) in enumerate(zip(
                data["traj.ts"], data["traj.gen"], data["traj.ref"]))]
    tracker.map_gen = info["map_gen"]
    tracker.n_kf_host = info["n_kf_host"]
    if tracker.n_kf_host > 0:
        # the newest keyframe by timestamp (slots recycle, so slot order is
        # not temporal)
        valid_ts = np.where(tracker.m.kf_valid.cpu().numpy(),
                            tracker.m.kf_ts.cpu().numpy(), -np.inf)
        tracker.last_kf_id = int(np.argmax(valid_ts))
        tracker.kf_seq = tracker.n_kf_host
    tracker.bias = _to_tensor(data["tracker.bias"], dev)
    tracker.imu_ready = info.get("imu_ready", False)
    tracker.viba_stage = info.get("viba_stage", 0)
    tracker.ts_first_kf = info.get("ts_first_kf")
    if voc is not None and tracker.db is not None:
        rebuild_database(tracker, voc, tracker.n_kf_host)
    if tracker.n_kf_host > 0:
        tracker.state = "RECENTLY_LOST"
        tracker.last = None
    return tracker
