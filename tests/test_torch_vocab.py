"""Parity of the PyTorch port's vocabulary and keyframe database with the
JAX package, both on the CPU (the port's plain K9 / K10 versions), on
clustered random descriptors made from a seed with numpy and a k = 6,
depth = 3 vocabulary:

- `train`: the same seed gives identical centers and weights;
- `transform`: identical word ids (-1 where invalid);
- `bow_vector`, `l1_score` (single and batched queries), `query`,
  `top_candidates` and `top_candidates_grouped`: identical ids, scores
  within 1e-6 (float32 sums of ~200 terms taken in another order);
- vocabulary files: an ORBvoc `.txt` or `.npz` written by one package loads
  in the other and gives the same words.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu.io import serialization as j_ser
from morb_slam_tpu.vocab import database as j_db
from morb_slam_tpu.vocab import tree as j_tree
from morb_slam_tpu_torch import convert
from morb_slam_tpu_torch.io import serialization as t_ser
from morb_slam_tpu_torch.vocab import database as t_db
from morb_slam_tpu_torch.vocab import tree as t_tree

torch.set_num_threads(1)
K_VOC, DEPTH = 6, 3


def _descriptors(rng, n, n_proto=300, flips=24):
    """(n, 8) uint32 descriptors: random prototypes with ~flips bits
    flipped each."""
    proto = rng.integers(0, 2 ** 32, (n_proto, 8), dtype=np.uint64)
    d = proto[rng.integers(0, n_proto, n)].astype(np.uint32)
    bits = np.unpackbits(d.view(np.uint8), axis=1)
    flip = rng.random(bits.shape) < flips / 256.0
    return np.packbits(bits ^ flip, axis=1).view(np.uint32)


@pytest.fixture(scope="module")
def vocabs():
    rng = np.random.default_rng(5)
    train_d = _descriptors(rng, 3000)
    jv = j_tree.train(train_d, k=K_VOC, depth=DEPTH, iters=3, seed=2)
    tv = t_tree.train(train_d, k=K_VOC, depth=DEPTH, iters=3, seed=2)
    # keyframe-like descriptor sets: 12 of 120 descriptors, some invalid
    sets = []
    for _ in range(12):
        d = _descriptors(rng, 120)
        valid = rng.random(120) < 0.9
        sets.append((d, valid))
    return jv, tv, sets


def _tdesc(d):
    return torch.from_numpy(d.view(np.int32).copy())


def _words(jv, tv, d, valid):
    jw = np.asarray(j_tree.transform(jv, jnp.asarray(d), jnp.asarray(valid)))
    tw = t_tree.transform(tv, _tdesc(d), torch.from_numpy(valid)).numpy()
    return jw, tw


def _bows(jv, tv, sets):
    jb, tb = [], []
    for d, valid in sets:
        jw, tw = _words(jv, tv, d, valid)
        jb.append(j_tree.bow_vector(jv, jnp.asarray(jw)))
        tb.append(t_tree.bow_vector(tv, torch.from_numpy(tw)))
    return jnp.stack(jb), torch.stack(tb)


def test_train_identical(vocabs):
    jv, tv, _ = vocabs
    assert tv.k == jv.k and tv.depth == jv.depth == DEPTH
    for jc, tc in zip(jv.centers, tv.centers):
        assert tc.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy().view(np.uint32),
                                      np.asarray(jc))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))
    back = convert.vocab_to_numpy(convert.vocab_from_numpy(jv._asdict()))
    for jc, c in zip(jv.centers, back["centers"]):
        np.testing.assert_array_equal(c, np.asarray(jc))


def test_transform_exact(vocabs):
    jv, tv, sets = vocabs
    for d, valid in sets[:4]:
        jw, tw = _words(jv, tv, d, valid)
        np.testing.assert_array_equal(tw, jw)
        assert (tw[~valid] == -1).all() and (tw[valid] >= 0).all()
    # no mask: every descriptor gets a word
    jw = np.asarray(j_tree.transform(jv, jnp.asarray(sets[0][0])))
    tw = t_tree.transform(tv, _tdesc(sets[0][0])).numpy()
    np.testing.assert_array_equal(tw, jw)


def test_bow_and_l1_score(vocabs):
    jv, tv, sets = vocabs
    jb, tb = _bows(jv, tv, sets)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    np.testing.assert_allclose(tb.sum(1).numpy(), 1.0, atol=1e-5)
    s_j = np.asarray(j_tree.l1_score(jb[3], jb))
    s_t = t_tree.l1_score(tb[3], tb).numpy()
    np.testing.assert_allclose(s_t, s_j, atol=1e-6)
    assert abs(s_t[3] - 1.0) < 1e-5
    S_j = np.asarray(j_tree.l1_score(jb[:4], jb))
    S_t = t_tree.l1_score(tb[:4], tb)
    assert S_t.shape == (4, len(sets))
    np.testing.assert_allclose(S_t.numpy(), S_j, atol=1e-6)


def _databases(vocabs, n_kf=16):
    jv, tv, sets = vocabs
    jb, tb = _bows(jv, tv, sets)
    jdb = j_db.empty(n_kf, jv.n_words)
    tdb = t_db.empty(n_kf, tv.n_words)
    for i in range(len(sets) - 1):           # the last set is the query
        slot = (3 * i) % n_kf
        jdb = j_db.add_keyframe(jdb, slot, jb[i])
        tdb = t_db.add_keyframe(tdb, slot, tb[i])
    return jdb, tdb, jb[-1], tb[-1]


def test_database_query_and_top_candidates(vocabs):
    jdb, tdb, jq, tq = _databases(vocabs)
    np.testing.assert_array_equal(tdb.valid.numpy(), np.asarray(jdb.valid))
    np.testing.assert_allclose(tdb.bow.numpy(), np.asarray(jdb.bow), atol=1e-6)
    exclude = np.zeros(16, bool)
    exclude[[3, 6]] = True
    for exc in (None, exclude):
        je = None if exc is None else jnp.asarray(exc)
        te = None if exc is None else torch.from_numpy(exc)
        s_j = np.asarray(j_db.query(jdb, jq, je))
        s_t = t_db.query(tdb, tq, te).numpy()
        np.testing.assert_allclose(s_t, s_j, atol=1e-6)
        assert (s_t[~np.asarray(jdb.valid)] == -1).all()
        ids_j, sc_j, ok_j = j_db.top_candidates(jdb, jq, 3, exclude=je)
        ids_t, sc_t, ok_t = t_db.top_candidates(tdb, tq, 3, exclude=te)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-6)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    # a database handed over from the JAX package scores the same
    tdb2 = convert.database_from_numpy(
        {k: np.asarray(v) for k, v in jdb._asdict().items()})
    np.testing.assert_allclose(t_db.query(tdb2, tq).numpy(),
                               np.asarray(j_db.query(jdb, jq)), atol=1e-6)


def test_top_candidates_grouped(vocabs):
    jdb, tdb, jq, tq = _databases(vocabs)
    rng = np.random.default_rng(11)
    covis = rng.integers(0, 40, (16, 16)).astype(np.int32)
    covis = np.triu(covis, 1)
    covis = covis + covis.T
    for exc in (None, np.arange(16) % 5 == 0):
        je = None if exc is None else jnp.asarray(exc)
        te = None if exc is None else torch.from_numpy(exc)
        ids_j, sc_j, ok_j = j_db.top_candidates_grouped(
            jdb, jq, 3, jnp.asarray(covis), exclude=je)
        ids_t, sc_t, ok_t = t_db.top_candidates_grouped(
            tdb, tq, 3, torch.from_numpy(covis), exclude=te)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        ok = np.asarray(ok_j)
        assert ok.any()
        np.testing.assert_array_equal(ids_t.numpy()[ok], np.asarray(ids_j)[ok])
        np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-6)


@pytest.mark.parametrize("fmt", ["txt", "npz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_vocabulary_files_cross_load(vocabs, tmp_path, fmt, writer):
    jv, tv, sets = vocabs
    path = str(tmp_path / f"voc.{fmt}")
    if writer == "jax":
        if fmt == "txt":
            j_tree.save_orbvoc_text(jv, path)
        else:
            j_ser.save_vocabulary(path, jv)
        loaded_t, loaded_j = t_ser.load_vocabulary(path), jv
    else:
        if fmt == "txt":
            t_tree.save_orbvoc_text(tv, path)
        else:
            t_ser.save_vocabulary(path, tv)
        loaded_t, loaded_j = tv, j_ser.load_vocabulary(path)
    for d, valid in sets[:3]:
        jw = np.asarray(j_tree.transform(loaded_j, jnp.asarray(d),
                                         jnp.asarray(valid)))
        tw = t_tree.transform(loaded_t, _tdesc(d),
                              torch.from_numpy(valid)).numpy()
        np.testing.assert_array_equal(tw, jw)
    # text weights carry 6 decimals, .npz weights are exact
    np.testing.assert_allclose(loaded_t.weights.numpy(),
                               np.asarray(loaded_j.weights),
                               atol=2e-6 if fmt == "txt" else 0)
