"""The row-fetch chain: the port's plain PyTorch version against the JAX
package's Pallas kernel (``onehot_fetch`` of
scripts/microbench_pallas_fetch.py, run in interpret mode on the CPU) on
the same numpy-seeded table and indices, and the CUDA kernel against
the plain version on a card.

Tolerance 0: a one-hot product selects one table row exactly, a
bfloat16 value widens to float32 exactly, and both versions add the
selected values to a float32 accumulator in the same order."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tryraytrace_tpu_torch.ops import fetch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES, STEPS = 512, 4


def _load_script(name):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pallas_script():
    return _load_script("microbench_pallas_fetch")


@pytest.mark.parametrize("m", [256, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_matches_pallas_kernel(pallas_script, m, dtype):
    rs = np.random.RandomState(m + (dtype == torch.float32))
    table, idx = fetch.make_inputs(rs, m, 128, dtype, True, LANES)
    acc, rowsum = fetch.fetch_chain_plain(table, idx, STEPS)
    assert acc.shape == rowsum.shape == (LANES, 1)
    assert acc.dtype == rowsum.dtype == torch.float32

    # The same table values: float32 of the (possibly bfloat16) table.
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jtable = jnp.asarray(table.to(torch.float32).numpy(), dtype=jdtype)
    np.testing.assert_array_equal(
        np.asarray(jtable.astype(jnp.float32)),
        table.to(torch.float32).numpy())
    want = pallas_script.onehot_fetch(jtable, jnp.asarray(idx.numpy()),
                                      steps=STEPS, interpret=True)
    np.testing.assert_array_equal(np.asarray(want), acc.numpy())

    # The chain depends on the data: it leaves the idx+1 sequence.
    col1 = table[:, 1].to(torch.float32).numpy()
    assert (col1 == np.trunc(col1)).all() and col1.max() >= m // 2
    seq = torch.from_numpy(rs.rand(m, 128).astype(np.float32)).to(dtype)
    seq[:, 0] = table[:, 0]
    assert not torch.equal(fetch.fetch_chain_plain(seq, idx, STEPS)[0], acc)


def test_rowsum_is_the_last_rows_column_order_sum():
    rs = np.random.RandomState(3)
    table, idx = fetch.make_inputs(rs, 256, 128, torch.bfloat16, True, 64)
    _, rowsum = fetch.fetch_chain_plain(table, idx, 3)
    tab = table.to(torch.float32).numpy()
    ix = idx.numpy()[:, 0].astype(np.int64)
    for step in range(3):
        last = ix
        ix = (ix + tab[ix, 1].astype(np.int64) + 1) % 256
    want = np.zeros(64, np.float32)
    for c in range(128):
        want = want + tab[last, c]
    np.testing.assert_array_equal(rowsum.numpy()[:, 0], want)


def test_dispatch_on_cpu_uses_plain_version():
    rs = np.random.RandomState(4)
    table, idx = fetch.make_inputs(rs, 256, 128, torch.float32, True, 64)
    before = fetch.fetch_chain_cuda.launches
    got = fetch.fetch_chain(table, idx, STEPS)
    want = fetch.fetch_chain_plain(table, idx, STEPS)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fetch.fetch_chain_cuda.launches == before
    with pytest.raises(ValueError):
        fetch.fetch_chain_cuda(table, idx, STEPS)
    with pytest.raises(ValueError):
        fetch.fetch_chain_plain(table, idx[:, 0], STEPS)
    with pytest.raises(ValueError):
        fetch.fetch_chain_plain(table.to(torch.float64), idx, STEPS)


def test_shared_memory_fit_rule():
    """``placement="shared"`` stages ``staged_rows``: the leading rows
    that a block's shared memory holds, never more bytes than it has."""

    def staged(m, w, dtype):
        return fetch.staged_rows(torch.empty((m, w), dtype=dtype))

    # 232,448 B of shared memory a block hold 908 rows of 256 B and 454 of
    # 512 B; the staging copy's mbarrier takes 8 B after the rows, one row
    # fewer of each.
    assert fetch.SHARED_LIMIT_BYTES == 232448
    assert fetch.STAGE_BARRIER_BYTES == 8
    assert staged(1024, 128, torch.bfloat16) == 908 - 1
    assert staged(1024, 256, torch.bfloat16) == 454 - 1
    assert staged(1024, 128, torch.float32) == 454 - 1
    # Tables that fit are staged whole.
    assert staged(512, 128, torch.bfloat16) == 512
    assert staged(256, 128, torch.bfloat16) == 256
    assert staged(1024, 4, torch.float32) == 1024
    assert staged(131072, 4, torch.float32) == (232448 - 8) // 16
    for m, w, dtype, _ in fetch.VARIANTS + fetch.LATENCY_VARIANTS:
        rows = staged(m, w, dtype)
        row_bytes = w * torch.empty((), dtype=dtype).element_size()
        assert row_bytes in fetch.ROW_BYTES
        assert 1 <= rows <= m
        assert rows * row_bytes + 8 <= fetch.SHARED_LIMIT_BYTES
        assert rows == m or (rows + 1) * row_bytes + 8 > 232448
    assert [v[:2] for v in fetch.VARIANTS[:5]] == [
        (1024, 128), (1024, 256), (512, 128), (256, 128), (1024, 128)]


def _floor_mod_mirror(x: np.ndarray, m: int) -> np.ndarray:
    """The kernel's floor modulo (csrc/fetch_chain.cu FloorMod) step by
    step in numpy uint64, each 32-bit result masked to 32 bits."""
    magic, shift = fetch.mod_constants(m)
    sh1, sh2 = np.uint64(min(shift, 1)), np.uint64(max(shift - 1, 0))
    mask, mu = np.uint64(0xFFFFFFFF), np.uint64(m)

    def umod(u):
        t = (np.uint64(magic) * u) >> np.uint64(32)
        q = ((t + (((u - t) & mask) >> sh1)) & mask) >> sh2
        return (u - ((q * mu) & mask)) & mask

    off = umod(np.array([2 ** 31], dtype=np.uint64))[0]
    a = umod((x.astype(np.int64) + 2 ** 31).astype(np.uint64))
    return np.where(a >= off, a - off, a + (mu - off)).astype(np.int64)


MODULI = sorted({m for m, *_ in fetch.VARIANTS + fetch.LATENCY_VARIANTS}
                | {1, 3, 2 ** 31 - 1})


@pytest.mark.parametrize("m", MODULI)
def test_floor_mod_constants_give_numpy_mod(m):
    magic, shift = fetch.mod_constants(m)
    assert 0 < magic < 2 ** 32 and 0 <= shift <= 31
    lo, hi = -2 ** 31, 2 ** 31 - 1
    edges = [0, 1, -1, m, -m, m - 1, -m + 1, m + 1, -m - 1, lo, hi,
             lo + 1, hi - 1]
    x = np.array([v for v in edges if lo <= v <= hi]
                 + list(np.random.RandomState(m % 9973).randint(
                     lo, hi + 1, 10000, dtype=np.int64)), dtype=np.int64)
    got = _floor_mod_mirror(x, m)
    want = np.mod(x, m)
    assert (want >= 0).all() and (want < m).all()
    np.testing.assert_array_equal(got, want)


def test_floor_mod_constants_refuse_moduli_out_of_range():
    for m in (0, -1, 2 ** 31):
        with pytest.raises(ValueError):
            fetch.mod_constants(m)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA fetch-chain kernel runs only on a CUDA device")
    rs = np.random.RandomState(0)
    cases = [(v, fetch.LANES) for v in fetch.VARIANTS]
    cases += [(v, fetch.LATENCY_LANES) for v in fetch.LATENCY_VARIANTS]
    for (m, w, dtype, dependent), lanes in cases:
        table, idx = fetch.make_inputs(rs, m, w, dtype, dependent, lanes)
        table, idx = table.cuda(), idx.cuda()
        want = fetch.fetch_chain_plain(table, idx, fetch.STEPS)
        for placement in fetch.PLACEMENTS:
            before = fetch.fetch_chain_cuda.launches
            got = fetch.fetch_chain_cuda(table, idx, fetch.STEPS, placement)
            torch.cuda.synchronize()
            assert fetch.fetch_chain_cuda.launches == before + 1
            assert all(torch.equal(g, x) for g, x in zip(got, want)), (
                m, w, dtype, dependent, placement)
