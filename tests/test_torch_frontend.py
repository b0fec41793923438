"""Parity of the PyTorch port's ORB frontend with the JAX package, on
test_frontend.synthetic_image and on one 384x288 PlaneWorld frame (500
features, 4 levels). On the CPU the port runs the plain versions of K1
(fast_select) and K2 (orb_describe).

Tolerances: level-0 FAST score exact; pyramid levels and blur within 1e-3
grey levels (the two frameworks sum the weights in another order); the
selected keypoints identical at level 0 and >= 99% shared on every level;
angles within 1e-4 rad and descriptor bits >= 99.9% identical on the shared
keypoints; `response` exact at level 0 and within 1e-3 above it, on valid
slots only (an invalid slot of the reference reads the wrapped score at
pixel (0, 0)).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import frontend as j_fe
from morb_slam_tpu.ops import fast as j_fast
from morb_slam_tpu.ops import image as j_img
from morb_slam_tpu.ops import orb_descriptor as j_orb
from morb_slam_tpu_torch import frontend as t_fe
from morb_slam_tpu_torch.ops import fast as t_fast
from morb_slam_tpu_torch.ops import image as t_img
from morb_slam_tpu_torch.ops import orb_descriptor as t_orb

from synthetic_world import PlaneWorld, camera_path
from test_frontend import synthetic_image

torch.set_num_threads(1)
N_FEAT, N_LEVELS = 500, 4
J_CFG = j_fe.OrbConfig(n_features=N_FEAT, n_levels=N_LEVELS)
T_CFG = t_fe.OrbConfig(n_features=N_FEAT, n_levels=N_LEVELS)


def _plane_frame():
    W, H, FX = 384, 288, 300.0
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    R, t = camera_path(4, step=0.05)[3]
    return np.clip(PlaneWorld(K, W, H, seed=0).render(R, t), 0, 255).astype(
        np.uint8)


IMAGES = {"synthetic": lambda: synthetic_image(),
          "planeworld": _plane_frame}


@pytest.fixture(scope="module", params=sorted(IMAGES))
def extracted(request):
    img = IMAGES[request.param]().astype(np.float32)
    J = jax.jit(j_fe.extract_orb, static_argnames="cfg")(jnp.asarray(img),
                                                         J_CFG)
    T = t_fe.extract_orb(torch.from_numpy(img), T_CFG)
    J = {k: np.asarray(v) for k, v in J._asdict().items()}
    J["desc"] = J["desc"].view(np.int32)
    T = {k: v.numpy() for k, v in T._asdict().items()}
    return request.param, img, J, T


def test_fast_score_level0_exact(extracted):
    _, img, _, _ = extracted
    js = np.asarray(j_fast.fast_score(jnp.asarray(img)))
    ts = t_fast.fast_score(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(ts, js)


def test_pyramid_and_blur_close(extracted):
    _, img, _, _ = extracted
    jl = j_img.build_pyramid(jnp.asarray(img), N_LEVELS, 1.2)
    tl = t_img.build_pyramid(torch.from_numpy(img), N_LEVELS, 1.2)
    for a, b in zip(jl, tl):
        assert b.shape == a.shape
        assert float(np.abs(np.asarray(a) - b.numpy()).max()) < 1e-3
        blur_err = np.abs(np.asarray(j_img.gaussian_blur(a))
                          - t_img.gaussian_blur(b).numpy()).max()
        assert float(blur_err) < 1e-3


def test_cell_selection_level0_exact(extracted):
    """K1's plain version against the reference's key map and per-cell
    top-2 (ties to the lower in-cell index)."""
    _, img, _, _ = extracted
    score = j_fast.fast_score(jnp.asarray(img))
    h, w = img.shape
    key = jnp.where((score > 7.0) & j_fast.nms3(score)
                    & j_fast.border_mask(h, w, j_fe.BORDER),
                    score + j_fe.STRONG_BOOST * (score > 20.0), -jnp.inf)
    C = j_fe.CELL
    hp, wp = -(-h // C) * C, -(-w // C) * C
    cells = jnp.pad(key, ((0, hp - h), (0, wp - w)),
                    constant_values=-jnp.inf).reshape(
        hp // C, C, wp // C, C).transpose(0, 2, 1, 3).reshape(-1, C * C)
    vals, idx = jax.lax.top_k(cells, 2)
    tk, ti, _ = t_fast.fast_select_plain(torch.from_numpy(img), 7.0, 20.0)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(vals))
    c = np.arange(cells.shape[0])[:, None]
    ys = (c // (wp // C)) * C + np.asarray(idx) // C
    xs = (c % (wp // C)) * C + np.asarray(idx) % C
    np.testing.assert_array_equal(ti.numpy(), ys * w + xs)


def _per_level_composition(levels, counts, cfg):
    """The port's level loop as it stood before K1 selected every level in
    one call: fast_select_plain per level, a stable descending sort of its
    cell keys, the level's n_keep best, their (y, x), level-0 uv, octave
    and size. Returns per level (yx, key, response, valid, uv, octave,
    size); octave and size held n_keep entries even where the level had
    fewer cell slots (JAX's top_k refuses that case)."""
    out = []
    for l, (lvl, n_keep) in enumerate(zip(levels, counts)):
        if n_keep == 0:
            continue
        w = lvl.shape[1]
        key, idx, score = t_fast.fast_select_plain(lvl, cfg.th_fast_lo,
                                                   cfg.th_fast_hi)
        vals, order = torch.sort(key.reshape(-1), descending=True,
                                 stable=True)
        top_vals, top_i = vals[:n_keep], order[:n_keep]
        pix = idx.reshape(-1)[top_i]
        valid = top_vals > -math.inf
        yx = torch.stack([pix // w, pix % w], dim=-1).to(torch.int32)
        yx = torch.where(valid[:, None], yx, torch.zeros_like(yx))
        s = cfg.scale ** l
        out.append((yx, top_vals, score.reshape(-1)[top_i], valid,
                    torch.stack([yx[:, 1].to(torch.float32) * s,
                                 yx[:, 0].to(torch.float32) * s], dim=-1),
                    torch.full((n_keep,), l, dtype=torch.int32),
                    torch.full((n_keep,), 31.0 * s, dtype=torch.float32)))
    return out


LEVEL_CASES = {"blank": ((64, 80), 150, 8), "top levels under n_keep":
               ((96, 128), 300, 8), "synthetic": (None, N_FEAT, N_LEVELS)}


@pytest.mark.parametrize("case", sorted(LEVEL_CASES))
def test_levels_plain_matches_per_level_composition(case):
    """K1's plain composition over an image's levels
    (`fast_select_levels_plain`, which `extract_orb` runs on the CPU)
    against the per-level loop it replaced: yx, key, response, valid and
    uv bitwise equal level by level, octave and size the level's; a level
    of fewer cell slots than n_keep keeps all of them and no more."""
    shape, n_feat, n_lv = LEVEL_CASES[case]
    if case == "blank":
        img = np.zeros(shape, np.float32)
    elif case == "synthetic":
        img = synthetic_image().astype(np.float32)
    else:
        img = np.random.default_rng(1).integers(0, 256, shape).astype(
            np.float32)
    cfg = t_fe.OrbConfig(n_features=n_feat, n_levels=n_lv)
    counts = cfg.per_level_counts()
    levels = t_img.build_pyramid(torch.from_numpy(img), n_lv, cfg.scale)
    got = t_fast.fast_select_levels_plain(levels, counts, cfg)
    keep = got.kept
    ref = _per_level_composition(levels, counts, cfg)
    assert [len(r[0]) for r in ref] == [k for k in keep if k]
    if case == "top levels under n_keep":
        assert keep[-1] < counts[-1]
    starts = np.cumsum([0] + [k for k in keep if k])
    for l, (a, b, r) in enumerate(zip(starts[:-1], starts[1:], ref)):
        for f, x, y in zip(t_fast.LevelKeypoints._fields[:5], got, r[:5]):
            assert torch.equal(x[a:b], y), (case, l, f)
        assert torch.equal(got.octave[a:b], r[5][:b - a])
        assert torch.equal(got.size[a:b], r[6][:b - a])
    assert bool(got.valid.any()) == (case != "blank")


def _level_slices():
    counts = T_CFG.per_level_counts()
    starts = np.cumsum([0] + counts)
    return [slice(starts[l], starts[l + 1]) for l in range(N_LEVELS)]


def _shared(J, T, sl):
    ju, tu = J["uv"][sl], T["uv"][sl]
    jv, tv = J["valid"][sl], T["valid"][sl]
    jset = {tuple(p) for p in ju[jv]}
    tset = {tuple(p) for p in tu[tv]}
    return jset, tset


def test_keypoint_sets(extracted, capsys):
    name, _, J, T = extracted
    for l, sl in enumerate(_level_slices()):
        jset, tset = _shared(J, T, sl)
        n_shared = len(jset & tset)
        with capsys.disabled():
            print(f"\n[{name}] level {l}: {len(jset)} reference keypoints, "
                  f"{len(tset)} port, {n_shared} shared")
        if l == 0:
            assert jset == tset
            np.testing.assert_array_equal(T["uv"][sl], J["uv"][sl])
            np.testing.assert_array_equal(T["valid"][sl], J["valid"][sl])
        assert n_shared >= 0.99 * max(len(jset), len(tset)), (l, n_shared)


def test_angles_and_descriptors_on_shared(extracted, capsys):
    name, _, J, T = extracted
    def key(F, i):
        return (*F["uv"][i], F["octave"][i])
    jmap = {key(J, i): i for i in range(len(J["uv"])) if J["valid"][i]}
    pairs = [(jmap[key(T, i)], i) for i in range(len(T["uv"]))
             if T["valid"][i] and key(T, i) in jmap]
    ji, ti = np.asarray(pairs).T
    dang = np.abs(np.remainder(T["angle"][ti] - J["angle"][ji] + math.pi,
                               2 * math.pi) - math.pi)
    bits = np.unpackbits((T["desc"][ti] ^ J["desc"][ji]).view(np.uint8))
    share = 1.0 - bits.sum() / bits.size
    with capsys.disabled():
        print(f"\n[{name}] {len(ji)} shared keypoints: max angle diff "
              f"{dang.max():.2e} rad, {int(bits.sum())} of {bits.size} "
              f"descriptor bits differ ({share:.5f} identical)")
    assert dang.max() < 1e-4
    assert share >= 0.999
    # FAST scores on levels >= 1 inherit the pyramid's rounding
    lvl0 = T["octave"][ti] == 0
    np.testing.assert_array_equal(T["response"][ti][lvl0],
                                  J["response"][ji][lvl0])
    np.testing.assert_allclose(T["response"][ti], J["response"][ji],
                               atol=1e-3)


def test_orb_describe_plain_matches_reference(extracted):
    """K2's plain version on the reference's own level-0 keypoints."""
    _, img, J, _ = extracted
    sl = _level_slices()[0]
    yx = np.stack([J["uv"][sl][:, 1], J["uv"][sl][:, 0]], -1).astype(np.int32)
    blur = np.array(j_img.gaussian_blur(jnp.asarray(img)))
    ja = np.asarray(j_orb.compute_orientations(jnp.asarray(img),
                                               jnp.asarray(yx)))
    jd = np.asarray(j_orb.compute_descriptors(jnp.asarray(blur),
                                              jnp.asarray(yx),
                                              jnp.asarray(ja))).view(np.int32)
    ta, td = t_orb.orb_describe(torch.from_numpy(img), torch.from_numpy(blur),
                                torch.from_numpy(yx))
    assert np.abs(ta.numpy() - ja).max() < 1e-4
    bits = np.unpackbits((td.numpy() ^ jd).view(np.uint8))
    assert bits.mean() <= 1e-3
    np.testing.assert_array_equal(
        t_orb.make_pattern(), np.asarray(j_orb.PATTERN))


def test_orb_describe_levels_matches_reference_per_level(extracted):
    """K2 over every level in one call (`orb_describe_levels`, its plain
    version on the CPU) on the port's pyramid and blur, at the reference's
    own keypoints of each level: angles within 1e-4 rad and descriptor bits
    >= 99.9% identical to the angles and descriptors of the reference's
    per-level `_extract_level`, level by level."""
    _, img, J, _ = extracted
    levels = t_img.build_pyramid(torch.from_numpy(img), N_LEVELS, 1.2)
    blurred = t_img.blur_levels(levels)
    yxs = []
    for l, sl in enumerate(_level_slices()):
        uv = J["uv"][sl] / np.float32(1.2 ** l)
        yxs.append(torch.from_numpy(np.stack(
            [np.rint(uv[:, 1]), np.rint(uv[:, 0])], -1).astype(np.int32)))
    before = dict(t_orb.LAUNCHES)
    ta, td = t_orb.orb_describe_levels(levels, blurred, yxs)
    assert t_orb.LAUNCHES == {"kernel": before["kernel"],
                              "plain": before["plain"] + 1}
    assert ta.shape == (N_FEAT,) and td.shape == (N_FEAT, 8)
    for l, sl in enumerate(_level_slices()):
        ok = J["valid"][sl]
        assert ok.sum() > 0
        dang = np.abs(np.remainder(ta[sl].numpy()[ok] - J["angle"][sl][ok]
                                   + math.pi, 2 * math.pi) - math.pi)
        assert dang.max() < 1e-4, (l, dang.max())
        bits = np.unpackbits((td[sl].numpy()[ok] ^ J["desc"][sl][ok]).view(
            np.uint8))
        assert bits.mean() <= 1e-3, (l, bits.mean())
