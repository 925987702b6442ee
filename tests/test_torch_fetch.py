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
    def fits(m, w, dtype):
        return fetch.fits_shared(torch.empty((m, w), dtype=dtype))

    assert fits(256, 128, torch.bfloat16) and fits(512, 128, torch.bfloat16)
    assert not fits(1024, 128, torch.bfloat16)
    assert not fits(1024, 256, torch.bfloat16)
    assert not fits(1024, 128, torch.float32)
    assert [v[:2] for v in fetch.VARIANTS[:5]] == [
        (1024, 128), (1024, 256), (512, 128), (256, 128), (1024, 128)]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA fetch-chain kernel runs only on a CUDA device")
    rs = np.random.RandomState(0)
    for m, w, dtype, dependent in fetch.VARIANTS:
        table, idx = fetch.make_inputs(rs, m, w, dtype, dependent,
                                       fetch.LANES)
        table, idx = table.cuda(), idx.cuda()
        want = fetch.fetch_chain_plain(table, idx, fetch.STEPS)
        for placement in fetch.PLACEMENTS:
            if placement == "shared" and not fetch.fits_shared(table):
                with pytest.raises(ValueError):
                    fetch.fetch_chain_cuda(table, idx, fetch.STEPS, placement)
                continue
            before = fetch.fetch_chain_cuda.launches
            got = fetch.fetch_chain_cuda(table, idx, fetch.STEPS, placement)
            torch.cuda.synchronize()
            assert fetch.fetch_chain_cuda.launches == before + 1
            assert all(torch.equal(g, x) for g, x in zip(got, want))
