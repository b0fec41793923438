"""The CUDA kernels K1-K3 of the PyTorch port against their plain PyTorch
versions on the card, on shapes and inputs the main path does not reach:
image sizes that are no multiple of the 16-px cell, flat images where every
key ties, empty keypoint and row sets, a single column, fully masked rows,
duplicated descriptors and unaligned views.

Marked `gpu`: each test skips without a CUDA card. On a machine with one
(and without JAX, so without tests/conftest.py):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: K1 and K3 exact; K2 angles within 1e-4 rad and descriptor bits
>= 99.9% identical (the kernel sums the moments in another order).
"""
import math

import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import frontend
from morb_slam_tpu_torch.ops import fast, hamming, image, orb_descriptor

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _image(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        img = rng.integers(0, 256, shape)
    else:                                   # flat blocks: keys tie everywhere
        blocks = rng.integers(0, 3, (shape[0] // 8 + 1, shape[1] // 8 + 1))
        img = np.kron(blocks, np.ones((8, 8)))[:shape[0], :shape[1]] * 60
    return img.astype(np.float32)


@pytest.mark.parametrize("kind", ["noise", "blocks"])
@pytest.mark.parametrize("shape", [(16, 16), (37, 53), (100, 130),
                                   (480, 752)])
def test_fast_select_exact(cuda, shape, kind):
    img = torch.from_numpy(_image(shape, kind)).to(cuda)
    got = fast.fast_select(img, 7.0, 20.0)
    want = fast.fast_select_plain(img, 7.0, 20.0)
    for name, g, w in zip(("key", "index", "score"), got, want):
        assert torch.equal(g, w), (name, int((g != w).sum()))


@pytest.mark.parametrize("n", [0, 7, 300])
def test_orb_describe_close(cuda, n):
    h, w = 133, 211
    rng = np.random.default_rng(n)
    img = image.gaussian_blur(torch.from_numpy(_image((h, w), "noise")))
    img = img.contiguous().to(cuda)
    blur = image.gaussian_blur(img).contiguous()
    yx = np.stack([rng.integers(16, h - 16, n), rng.integers(16, w - 16, n)],
                  axis=-1).astype(np.int32).reshape(n, 2)
    if n >= 7:                              # the extreme admissible corners
        yx[:4] = [[16, 16], [16, w - 17], [h - 17, 16], [h - 17, w - 17]]
    yx = torch.from_numpy(yx).to(cuda)
    ang, desc = orb_descriptor.orb_describe(img, blur, yx)
    ang0 = orb_descriptor.compute_orientations(img, yx)
    desc0 = orb_descriptor.compute_descriptors(blur, yx, ang0)
    assert ang.shape == ang0.shape and desc.shape == desc0.shape == (n, 8)
    if n == 0:
        return
    dang = torch.remainder(ang - ang0 + math.pi, 2 * math.pi) - math.pi
    assert float(dang.abs().max()) < 1e-4
    bits = orb_descriptor.unpack_bits(desc) != orb_descriptor.unpack_bits(
        desc0)
    assert int(bits.sum()) <= max(1, 1e-3 * bits.numel()), int(bits.sum())


def _desc(rng, n):
    return torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(
            np.int32))


CASES = {
    "no rows": (0, 5, 0.5),
    "one column": (9, 1, 0.5),
    "partial chunk": (13, 1000, 0.3),
    "full mask": (1200, 1200, 1.0),
    "empty mask": (40, 300, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hamming_top2_exact(cuda, case):
    n, m, density = CASES[case]
    rng = np.random.default_rng(len(case))
    a = _desc(rng, n).to(cuda)
    b = _desc(rng, m).to(cuda)
    mask = torch.from_numpy(rng.random((n, m)) < density).to(cuda)
    got = hamming.hamming_top2(a, b, mask)
    want = hamming.hamming_top2_plain(a, b, mask)
    for name, g, w in zip(("best", "index", "second"), got, want):
        assert torch.equal(g, w), (name, int((g != w).sum()))


def test_hamming_top2_ties_and_unaligned_views(cuda):
    rng = np.random.default_rng(3)
    b = _desc(rng, 300).to(cuda)
    b[150:] = b[:150]                       # every best distance ties twice
    flat = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                      b[rng.integers(0, 300, 77)].reshape(-1)])
    a = flat[1:].view(77, 8)                # 4-byte offset: not 16-aligned
    assert a.data_ptr() % 16 != 0
    big = torch.from_numpy(rng.random((77, 301)) < 0.7).to(cuda)
    mask = big[:, 1:]                       # a strided view
    got = hamming.hamming_top2(a, b, mask)
    want = hamming.hamming_top2_plain(a, b, mask)
    for name, g, w in zip(("best", "index", "second"), got, want):
        assert torch.equal(g, w), (name, int((g != w).sum()))
    assert int((got[0] == 0).sum()) > 0     # some rows found their copy


def test_wrappers_refuse_bad_inputs_on_the_card(cuda):
    before = [dict(m.LAUNCHES) for m in (fast, orb_descriptor, hamming)]
    img = torch.zeros((48, 64), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        fast.fast_select(img, 7.0, 20.0)
    with pytest.raises(ValueError):
        orb_descriptor.orb_describe(img.float(), img.float(), torch.zeros(
            (3, 2), dtype=torch.int64, device=cuda))
    d = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        hamming.hamming_top2(d, d[:0], torch.zeros((4, 0), dtype=torch.bool,
                                                   device=cuda))
    assert [dict(m.LAUNCHES) for m in (fast, orb_descriptor, hamming)] == \
        before


def test_extract_orb_level0_matches_cpu(cuda):
    """The whole frontend on the card (K1, K2, the pyramid and blur) keeps
    the CPU run's level-0 keypoints, angles and descriptors."""
    rng = np.random.default_rng(5)
    img = image.gaussian_blur(torch.from_numpy(_image((240, 320), "noise")))
    img = image.gaussian_blur(img) + torch.from_numpy(
        rng.normal(0, 4, (240, 320)).astype(np.float32))
    cfg = frontend.OrbConfig(n_features=500, n_levels=4)
    n0 = cfg.per_level_counts()[0]
    got = frontend.extract_orb(img.to(cuda), cfg)
    want = frontend.extract_orb(img, cfg)
    assert torch.equal(got.uv[:n0].cpu(), want.uv[:n0])
    assert torch.equal(got.valid[:n0].cpu(), want.valid[:n0])
    ok = want.valid[:n0]
    dang = torch.remainder(got.angle[:n0].cpu() - want.angle[:n0] + math.pi,
                           2 * math.pi) - math.pi
    assert float(dang[ok].abs().max()) < 1e-4
    bits = orb_descriptor.unpack_bits(got.desc[:n0].cpu()[ok]) != \
        orb_descriptor.unpack_bits(want.desc[:n0][ok])
    assert float(bits.float().mean()) <= 1e-3
