"""The port's counter-based RNG (int64 arithmetic mod 2**32) against
the JAX package's NumPy uint32 spec: bit-equal on ~1e6 draws,
including words near 2**32."""

import numpy as np
import torch

from tryraytrace_tpu.core import rng as jrng
from tryraytrace_tpu.core import vec as jvec
from tryraytrace_tpu_torch.core import rng as trng
from tryraytrace_tpu_torch.core import vec as tvec

torch.set_num_threads(1)

N = 1 << 20


def _triples(seed):
    r = np.random.RandomState(seed)
    seeds = r.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    streams = r.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    draws = r.randint(0, 4 + 8 * 30, size=N).astype(np.uint32)
    # Words at the top of the range, where a missed mask would show.
    top = np.uint32(0xFFFFFFFF) - r.randint(0, 64, size=N // 8).astype(
        np.uint32)
    seeds[: N // 8] = top
    streams[N // 8: N // 4] = top
    return seeds, streams, draws


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def test_uniform_bit_equal():
    seeds, streams, draws = _triples(0)
    want = jrng.uniform(seeds, streams, draws, np)
    got = trng.uniform(_t(seeds), _t(streams), _t(draws)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_hash3_bit_equal_with_scalar_slot():
    seeds, streams, _ = _triples(1)
    with np.errstate(over="ignore"):
        want = jrng.hash3(seeds, streams, 7, np)
    got = trng.hash3(_t(seeds), _t(streams), 7).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), got)


def test_sample_seed_bit_equal():
    r = np.random.RandomState(2)
    frames = r.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    frames[:16] = 0xFFFFFFFF
    samples = r.randint(0, 64, size=N).astype(np.uint32)
    for spp in (1, 3, 16):
        with np.errstate(over="ignore"):
            want = jrng.sample_seed(frames, spp, samples, np)
        got = trng.sample_seed(_t(frames), spp, _t(samples)).numpy()
        np.testing.assert_array_equal(want.astype(np.int64), got)
        assert trng.sample_seed(int(frames[0]), spp, 5) == int(
            jrng.sample_seed(int(frames[0]), spp, 5))


def test_vec_helpers_match_numpy():
    r = np.random.RandomState(3)
    a = r.normal(size=(4096, 3)).astype(np.float32)
    b = r.normal(size=(4096, 3)).astype(np.float32)
    a[:8] = 0.0
    b[8:16] = 1e-9
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(jvec.dot(a, b, np), tvec.dot(ta, tb))
    np.testing.assert_array_equal(jvec.cross(a, b, np), tvec.cross(ta, tb))
    np.testing.assert_array_equal(jvec.norm(a, np), tvec.norm(ta))
    np.testing.assert_array_equal(jvec.safe_inv(b, np), tvec.safe_inv(tb))
