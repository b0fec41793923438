"""The PyTorch port's native image loader (mirrors
tests/test_native_loader.py): decoding against cv2 (8- and 16-bit grey,
RGB and PGM), the prefetching loader's order, and the dataset reader
taking the native path; the port's own copy of the C++ source, built into
`morb_slam_tpu_torch/_build/`, decodes every image exactly as the JAX
package's library does.
"""
import os

import numpy as np
import pytest
import torch

from morb_slam_tpu.io import native_loader as j_native_loader
from morb_slam_tpu_torch.io import datasets, native_loader

torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def lib():
    lib = native_loader.get_lib()
    assert lib is not None, native_loader.build_error()
    return lib


def _write_images(tmp_path):
    rng = np.random.default_rng(0)
    paths = {}
    g8 = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    p = str(tmp_path / "gray8.png")
    cv2.imwrite(p, g8)
    paths[p] = g8.astype(np.float32)

    g16 = rng.integers(0, 65536, (32, 40), dtype=np.uint16)
    p = str(tmp_path / "gray16.png")
    cv2.imwrite(p, g16)
    paths[p] = (g16 / 257.0).astype(np.float32)

    rgb = rng.integers(0, 256, (24, 36, 3), dtype=np.uint8)
    p = str(tmp_path / "rgb.png")
    cv2.imwrite(p, rgb)  # cv2 writes BGR
    r, g, b = (rgb[..., 2].astype(np.float32), rgb[..., 1].astype(np.float32),
               rgb[..., 0].astype(np.float32))
    paths[p] = 0.299 * r + 0.587 * g + 0.114 * b

    pgm = rng.integers(0, 256, (20, 30), dtype=np.uint8)
    p = str(tmp_path / "img.pgm")
    cv2.imwrite(p, pgm)
    paths[p] = pgm.astype(np.float32)
    return paths


def test_decode_parity(lib, tmp_path):
    for path, expect in _write_images(tmp_path).items():
        got = native_loader.decode_gray(path)
        assert got is not None, path
        assert got.shape == expect.shape, path
        assert np.max(np.abs(got - expect)) < 1.0, \
            (path, np.max(np.abs(got - expect)))


def test_prefetch_loader_order(lib, tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    imgs = []
    for i in range(20):
        img = rng.integers(0, 256, (16, 24), dtype=np.uint8)
        p = str(tmp_path / f"f{i:03d}.png")
        cv2.imwrite(p, img)
        paths.append(p)
        imgs.append(img.astype(np.float32))
    ld = native_loader.PrefetchLoader(paths, n_workers=3, prefetch=4)
    assert (ld.width, ld.height) == (24, 16)
    seen = []
    for idx, frame in ld:
        seen.append(idx)
        assert np.array_equal(frame, imgs[idx]), idx
    ld.close()
    assert seen == list(range(20))


def test_dataset_loader_uses_native(lib, tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (16, 16), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    cv2.imwrite(p, img)
    out = datasets._imread_gray(p)
    assert np.array_equal(out, img.astype(np.float32))


def test_port_decode_equals_jax_decode(lib, tmp_path):
    """Bit-equal grey images from the port's library and the JAX
    package's, built from two copies of the same source."""
    if j_native_loader.get_lib() is None:
        pytest.skip("the JAX package's native library did not build")
    paths = list(_write_images(tmp_path))
    for p in paths:
        a = native_loader.decode_gray(p)
        b = j_native_loader.decode_gray(p)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_library_is_built_from_the_ports_source(lib):
    """The port loads its own build of morb_slam_tpu_torch/native/loader.cc,
    never the committed native/ library."""
    pkg = os.path.dirname(os.path.dirname(native_loader.__file__))
    assert native_loader.SRC == os.path.join(pkg, "native", "loader.cc")
    assert os.path.dirname(lib._name) == os.path.join(pkg, "_build")
