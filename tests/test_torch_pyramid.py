"""K6's host-side tables on the CPU: the bands that `csrc/pyramid_blur.cu`
reads (`ops.image.band_tables`), summed as the kernel sums them (each
output's taps in ascending input order in float32, rows then columns),
reproduce the plain pyramid within 1e-3 grey levels on every level of the
mono path's 480x752 / 8 levels, the merge path's 288x384 / 4 levels and
odd sizes; every band is a run of at most MAX_TAPS taps and every tile
stays within the kernel's shared-memory span. The plain pyramid itself
matches the JAX package's (tests/test_torch_frontend.py holds that).
"""
import numpy as np
import pytest
import torch

from morb_slam_tpu_torch.ops import image

torch.set_num_threads(1)


def _unpack(blob, ho, wo):
    b = blob.numpy()
    rs, rc = b[:ho], b[ho:2 * ho]
    cs, cc = b[2 * ho:2 * ho + wo], b[2 * ho + wo:2 * ho + 2 * wo]
    w = b[2 * ho + 2 * wo:].view(np.float32)
    return (rs, rc, w[:ho * image.MAX_TAPS].reshape(ho, -1), cs, cc,
            w[ho * image.MAX_TAPS:].reshape(wo, -1))


def _banded(src, rs, rc, rw, cs, cc, cw):
    """The kernel's arithmetic in numpy float32, one add at a time."""
    ho, wo = len(rs), len(cs)
    tmp = np.zeros((ho, src.shape[1]), np.float32)
    for o in range(ho):
        for t in range(rc[o]):
            tmp[o] = tmp[o] + rw[o, t] * src[rs[o] + t]
    out = np.zeros((ho, wo), np.float32)
    for o in range(wo):
        for t in range(cc[o]):
            out[:, o] = out[:, o] + cw[o, t] * tmp[:, cs[o] + t]
    return out


@pytest.mark.parametrize("shape,n_levels", [((480, 752), 8), ((288, 384), 4),
                                            ((131, 97), 5)])
def test_band_tables_reproduce_plain_pyramid(shape, n_levels):
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32))
    img = image.gaussian_blur_plain(img)
    plain = image.build_pyramid_plain(img, n_levels, 1.2)
    shapes = image.level_shapes(*shape, n_levels, 1.2)
    tables = image.band_tables(*shape, n_levels, 1.2, "cpu")
    assert len(tables) == n_levels - 1
    src = img.numpy()
    for l, blob in enumerate(tables, start=1):
        ho, wo = shapes[l]
        rs, rc, rw, cs, cc, cw = _unpack(blob, ho, wo)
        assert 1 <= rc.min() and rc.max() <= image.MAX_TAPS
        assert 1 <= cc.min() and cc.max() <= image.MAX_TAPS
        assert (rs + rc).max() <= shapes[l - 1][0]
        assert (cs + cc).max() <= shapes[l - 1][1]
        for x0 in range(0, wo, image.TILE_X):
            span = (cs + cc)[x0:x0 + image.TILE_X].max() - cs[x0]
            assert span <= image.TILE_SPAN
        # the band weights are resize_weights' non-zero entries
        Wr = image.resize_weights(shapes[l - 1][0], ho)
        for o in (0, ho // 2, ho - 1):
            np.testing.assert_array_equal(
                rw[o, :rc[o]], Wr[rs[o]:rs[o] + rc[o], o])
            assert not Wr[:rs[o], o].any() and not Wr[rs[o] + rc[o]:, o].any()
        src = _banded(src, rs, rc, rw, cs, cc, cw)
        err = np.abs(src - plain[l].numpy()).max()
        assert err < 1e-3, (l, err)


def test_blur_levels_plain_is_gaussian_blur_per_level():
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(0, 255, (97, 131)).astype(np.float32))
    levels = image.build_pyramid(img, 4, 1.2)
    for a, l in zip(image.blur_levels(levels), levels):
        assert torch.equal(a, image.gaussian_blur_plain(l))
        assert torch.equal(a, image.gaussian_blur(l))


def _fused_tile(src, rs, rc, rw, cs, cc, cw, span, rspan, x0, y0):
    """One pyramid tile of the one-launch kernel, as it indexes it: the
    tile's input window (rspan rows from its first row's start, span
    columns from its first column's), pass 1 from that window, then
    pass 2; numpy float32, one add at a time."""
    rows = np.arange(y0, min(y0 + image.FUSED_TY, len(rs)))
    cols = np.arange(x0, min(x0 + image.FUSED_TX, len(cs)))
    row0, col0 = rs[y0], cs[x0]
    stage = src[row0:row0 + min(rspan, src.shape[0] - row0),
                col0:col0 + min(span, src.shape[1] - col0)]
    tmp = np.zeros((len(rows), stage.shape[1]), np.float32)
    for i, oy in enumerate(rows):
        assert rs[oy] >= row0 and rs[oy] + rc[oy] - row0 <= len(stage)
        for t in range(rc[oy]):
            tmp[i] = tmp[i] + rw[oy, t] * stage[rs[oy] + t - row0]
    out = np.zeros((len(rows), len(cols)), np.float32)
    for j, ox in enumerate(cols):
        assert cs[ox] >= col0 and cs[ox] + cc[ox] - col0 <= stage.shape[1]
        for t in range(cc[ox]):
            out[:, j] = out[:, j] + cw[ox, t] * tmp[:, cs[ox] - col0 + t]
    return out, rows, cols


@pytest.mark.parametrize("shape,n_levels", [((480, 752), 8), ((480, 640), 8),
                                            ((512, 512), 8), ((131, 97), 8),
                                            ((7, 5), 2)])
def test_fused_plan_tiles_reproduce_level_chain(shape, n_levels):
    """The one-launch K6's tables (`image.fused_plan`): the same bands as
    the per-level path's, each level's offset, tile counts and first blur
    tile, and at the first, a middle and the last tile of every level the
    tile summed as the one launch indexes it (from its staged input
    window) equal bit for bit to the per-level path's arithmetic."""
    rng = np.random.default_rng(2)
    img = image.gaussian_blur_plain(torch.from_numpy(
        rng.integers(0, 256, shape).astype(np.float32)))
    blob, t, shapes, offs, total = image.fused_plan(*shape, n_levels, 1.2,
                                                    "cpu")
    assert shapes == image.level_shapes(*shape, n_levels, 1.2)
    assert total == sum(h * w for h, w in shapes)
    tables = image.band_tables(*shape, n_levels, 1.2, "cpu")
    src = img.numpy()
    for l, (ho, wo) in enumerate(shapes):
        assert (t.off[l], t.h[l], t.w[l]) == (offs[l], ho, wo)
        assert t.tiles[l] == -(-wo // image.FUSED_TX) * -(-ho // image.FUSED_TY)
        assert t.btile0[l + 1] == t.btile0[l] + t.tiles[l]
        if l == 0:
            continue
        band = blob[t.band[l]:t.band[l] + tables[l - 1].numel()]
        assert torch.equal(band, tables[l - 1])
        assert 0 < t.span[l] <= image.FUSED_SPAN
        assert 0 < t.rspan[l] <= image.FUSED_RSPAN
        parts = _unpack(band, ho, wo)
        lvl = _banded(src, *parts)
        tx = -(-wo // image.FUSED_TX)
        for tile in sorted({0, t.tiles[l] // 2, t.tiles[l] - 1}):
            x0 = (tile % tx) * image.FUSED_TX
            y0 = (tile // tx) * image.FUSED_TY
            got, rows, cols = _fused_tile(src, *parts, t.span[l],
                                          t.rspan[l], x0, y0)
            np.testing.assert_array_equal(got, lvl[np.ix_(rows, cols)])
        src = lvl


def test_pyramid_blur_plain_on_cpu():
    """pyramid_blur on a CPU image: the plain pyramid and the plain blur of
    each level, counted as plain calls."""
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.uniform(0, 255, (97, 131)).astype(np.float32))
    before = dict(image.LAUNCHES)
    levels, blurred = image.pyramid_blur(img, 4, 1.2)
    assert image.LAUNCHES == {"kernel": before["kernel"],
                              "plain": before["plain"] + 5}
    for a, b in zip(levels, image.build_pyramid_plain(img, 4, 1.2)):
        assert torch.equal(a, b)
    for a, l in zip(blurred, levels):
        assert torch.equal(a, image.gaussian_blur_plain(l))
