"""The SIFT kernels (`csrc/sift.cu`: S1, S2a, S2b) and the two-NN matcher
(`csrc/knn2.cu`: S3) on the card against their plain twins.

This file imports torch and the port only, so it runs on a machine with
the card and without JAX, flax or OpenCV:

    python3 -m pytest tests/test_torch_sift_card.py -m cuda -q

Every test is marked `cuda` and skips without a card; the card is looked
for inside the `cuda` fixture. Frames: the committed KITTI frame and a
376x1240 SyntheticImageSequence frame (seed 1, 400 corners). The pyramid
is torch elementwise code on either device, so the card's equals the CPU's
bit for bit. Each kernel runs on the card's pyramid; S1's plain twin runs
on the same tensors, S2a's and S2b's on a host copy of them (on the card
their histograms sum by `scatter_add_`'s atomics, in no fixed order; on
the CPU in raster order, as the kernels sum).
"""

import os

import numpy as np
import pytest
import torch

from deepfepe_tpu_torch.frontend import sift
from deepfepe_tpu_torch.ops import knn2 as knn2_ops
from deepfepe_tpu_torch.ops import sift as sift_ops

KITTI = os.path.join(os.path.dirname(__file__), "fixtures", "image_io", "kitti_grey_q95.jpg")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frame(name):
    if name == "kitti":
        from deepfepe_tpu_torch.utils.jpeg import read_jpeg_grey

        return read_jpeg_grey(KITTI)
    from deepfepe_tpu_torch.data import SyntheticImageSequence

    seq = SyntheticImageSequence(n_frames=1, image_size=(376, 1240), seed=1, n_corners=400)
    return np.rint(seq.frame(0) * 255).astype(np.uint8)


@pytest.fixture(scope="module", params=["kitti", "synthetic"])
def pyramids(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    img = torch.as_tensor(_frame(request.param))
    with torch.no_grad():
        return sift.build_pyramid(img.cuda()), sift.build_pyramid(img)


@pytest.mark.cuda
def test_pyramid_card_equals_cpu(cuda, pyramids):
    card, cpu = pyramids
    assert card.rows == cpu.rows and card.cols == cpu.cols
    assert torch.equal(card.gauss.cpu(), cpu.gauss)
    assert torch.equal(card.dog.cpu(), cpu.dog)


@pytest.mark.cuda
def test_s1_matches_plain_on_card(cuda, pyramids):
    pyr = pyramids[0]
    got = sift_ops.sift_extrema(pyr)
    want = sift.extrema_plain(pyr)
    assert len(got) == len(want) > 0
    assert torch.equal(got.idx, want.idx)
    assert torch.allclose(got.kp, want.kp, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_s1_overflow_raises(cuda, pyramids):
    with pytest.raises(RuntimeError, match="overflow"):
        sift_ops.sift_extrema(pyramids[0], capacity=1)


@pytest.mark.cuda
def test_s1_launches_again_past_its_first_buffer(cuda, pyramids, monkeypatch):
    pyr = pyramids[0]
    want = sift.extrema_plain(pyr)
    monkeypatch.setattr(sift_ops, "extrema_capacity", lambda p: 16)
    before = sift_ops.sift_extrema.launches
    got = sift_ops.sift_extrema(pyr)
    assert sift_ops.sift_extrema.launches == before + 2
    assert torch.equal(got.idx, want.idx)
    assert torch.allclose(got.kp, want.kp, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_s2a_matches_plain_on_card(cuda, pyramids):
    pyr = pyramids[0]
    cands = sift.extrema_plain(pyr)
    got = sift_ops.sift_orientation(pyr, cands).to("cpu")
    want = sift.orientation_plain(pyr.to("cpu"), cands.to("cpu"))
    assert len(got) == len(want) > 0
    assert torch.equal(got.src, want.src)
    assert torch.equal(got.kp[:, [0, 1, 2, 4, 5]], want.kp[:, [0, 1, 2, 4, 5]])
    da = (got.kp[:, 3] - want.kp[:, 3]).abs()
    assert float(torch.minimum(da, 360 - da).max()) <= 1e-3


@pytest.mark.cuda
def test_s2b_matches_plain_on_card(cuda, pyramids):
    pyr = pyramids[0]
    host = pyr.to("cpu")
    oriented = sift.orientation_plain(host, sift.extrema_plain(pyr).to("cpu"))
    kp = sift.half_scale(oriented.kp[sift_ops.order_keypoints(oriented.kp, 2000)])
    got = sift_ops.sift_descriptor(pyr, kp.to(cuda)).cpu()
    want = sift.descriptor_plain(host, kp)
    assert got.shape == want.shape == (kp.shape[0], 128)
    diff = (got - want).abs()
    assert float(diff.max()) <= 1
    assert float((diff.amax(1) == 0).float().mean()) >= 0.99
    assert bool(((got >= 0) & (got <= 255) & (got == got.round())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(1, 1), (1, 2), (300, 257), (2000, 1900)])
def test_s3_matches_plain_bit_for_bit(cuda, n1, n2):
    rng = np.random.RandomState(n1 + n2)
    d1 = rng.randint(0, 256, (n1, 128)).astype(np.float32)
    d2 = rng.randint(0, 256, (n2, 128)).astype(np.float32)
    if n2 > 260:  # equal rows straddling the kernel's 256-row chunks
        d2[255:258] = d2[100]
        d1[:5] = d2[100]
    nn, dist = knn2_ops.knn2(torch.as_tensor(d1, device=cuda), torch.as_tensor(d2, device=cuda))
    nn_p, dist_p = knn2_ops.knn2_plain(torch.as_tensor(d1), torch.as_tensor(d2))
    assert torch.equal(nn.cpu(), nn_p)
    if n2 > 1:
        assert torch.equal(dist.cpu(), dist_p)
    if n2 > 260:
        assert nn[0].tolist() == [100, 255]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kitti", "synthetic"])
@pytest.mark.parametrize("n_features", [2000, 300])
def test_sift_detect_card_matches_cpu(cuda, name, n_features):
    img = _frame(name)
    kp_c, des_c = sift.detect_and_compute(img, n_features, cuda)
    kp, des = sift.detect_and_compute(img, n_features, "cpu")
    assert kp_c.shape == kp.shape
    assert torch.equal(kp_c[:, [0, 1, 4, 5]].cpu(), kp[:, [0, 1, 4, 5]])
    assert torch.allclose(kp_c[:, 2:4].cpu(), kp[:, 2:4], rtol=1e-6, atol=1e-3)
    assert float((des_c.cpu() - des).abs().max()) <= 1
