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
