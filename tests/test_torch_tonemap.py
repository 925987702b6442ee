"""The tonemap: the plain PyTorch version against the JAX package's host
tonemap and its Pallas kernel (run in interpret mode on the CPU), and
the CUDA kernel against the plain version on a card."""

import numpy as np
import pytest
import torch

from tryraytrace_tpu.io.snapshot import tonemap_accum as jtonemap_accum
from tryraytrace_tpu.ops.pallas_tonemap import tonemap_image
from tryraytrace_tpu_torch.io.snapshot import tonemap_accum as ttonemap_accum
from tryraytrace_tpu_torch.ops import tonemap as tm

torch.set_num_threads(1)


def _accum(seed, spp, n=5000):
    """Normal noise around the visible range, so values land below 0,
    inside (0, 1) and above 1 after the division by spp."""
    r = np.random.RandomState(seed)
    return (r.normal(0.5, 0.6, size=(n, 3)) * spp).astype(np.float32)


@pytest.mark.parametrize("spp", [1, 3, 7])
def test_plain_matches_host_and_pallas(spp):
    acc = _accum(spp, spp)
    got = tm.tonemap_plain(torch.from_numpy(acc), spp).numpy()
    assert got.dtype == np.uint8 and got.shape == acc.shape
    np.testing.assert_array_equal(got, jtonemap_accum(acc, spp))
    pallas = np.asarray(tonemap_image(acc, spp, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ttonemap_accum(acc, spp))
    assert 0 < (got == 0).mean() < 1 and (got == 255).any()


def test_inv_spp_matches_both_reference_paths():
    # Host path: float64 quotient rounded to float32; device path: a
    # float32 division.  They agree on every count the renderer uses.
    for spp in list(range(1, 4097)) + [65535, 1 << 20, 12345677]:
        want = np.float32(1.0 / spp)
        assert tm.inv_spp(spp) == want == np.float32(1.0) / np.float32(spp)
    assert tm.inv_spp(0) == 1.0


def test_dispatch_on_cpu_uses_plain_version():
    acc = torch.from_numpy(_accum(9, 2, n=64))
    before = tm.tonemap_cuda.launches
    np.testing.assert_array_equal(tm.tonemap(acc, 2).numpy(),
                                  tm.tonemap_plain(acc, 2).numpy())
    assert tm.tonemap_cuda.launches == before
    with pytest.raises(ValueError):
        tm.tonemap_cuda(acc, 2)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA tonemap kernel runs only on a CUDA device")
    for spp in (1, 3, 7):
        acc = torch.from_numpy(_accum(spp, spp, n=960000)).cuda()
        before = tm.tonemap_cuda.launches
        got = tm.tonemap_cuda(acc, spp)
        torch.cuda.synchronize()
        assert tm.tonemap_cuda.launches == before + 1
        want = tm.tonemap_plain(acc, spp)
        assert torch.equal(got, want)
        with pytest.raises(ValueError):
            tm.tonemap_cuda(acc[:, :2], spp)
        with pytest.raises(ValueError):
            tm.tonemap_cuda(acc.t(), spp)
    # A ragged tail past the last 16-byte piece, and a sum that does not
    # start on a 16-byte boundary (every float takes the scalar loop).
    acc = torch.from_numpy(_accum(5, 3, n=1001)).cuda()
    assert torch.equal(tm.tonemap_cuda(acc, 3), tm.tonemap_plain(acc, 3))
    flat = torch.from_numpy(_accum(6, 3, n=778)).cuda().reshape(-1)
    acc = flat[1:2332].view(777, 3)
    assert acc.is_contiguous() and acc.data_ptr() % 16
    assert torch.equal(tm.tonemap_cuda(acc, 3), tm.tonemap_plain(acc, 3))
