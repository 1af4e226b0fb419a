"""The latency probe (``ops/fma_probe.py``): its plain version against a
numpy restatement of the JAX package's Pallas probe
(``benchmarks/experiments/sublane_probe.py:33-39``; that script runs its
kernels at import, so it cannot be imported), the CPU routing and the
wrapper's checks; and, on a CUDA card, the kernel against its plain
version.

Tolerances: the plain version and the numpy restatement run the same
unfused operations in the same order, so they are equal bit for bit in
float32 and float64.  The kernel fuses each multiply-add: float64 within
rtol 1e-9 of the plain version; float32 within 2e-3 of the largest
|value| of the plain version run in float64 (the recurrence is nearly a
rotation and carries rounding forward, about iters x 6e-8 relative).

The ``cuda`` cases also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fma_probe.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from mind_the_gaps_tpu_torch.ops.fma_probe import (  # noqa: E402
    block_threads,
    fma_chain,
    fma_chain_plain,
)


def _numpy_probe(x, iters):
    """sublane_probe.py's kernel body, restated in numpy in x's dtype."""
    f = x.dtype.type
    a = x
    b = a * f(1.000001) + f(0.5)
    for _ in range(iters):
        a = a * f(0.999999) + b
        b = b * f(1.000001) - a * f(1e-7)
    return a + b


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(2048,), (8, 256), (3, 5)])
def test_plain_probe_equals_numpy_restatement(dtype, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(dtype)
    out = fma_chain(torch.as_tensor(x), 300)
    assert out.dtype == torch.float32 if dtype == np.float32 else torch.float64
    np.testing.assert_array_equal(out.numpy(), _numpy_probe(x, 300))
    np.testing.assert_array_equal(fma_chain_plain(torch.as_tensor(x), 0).numpy(), _numpy_probe(x, 0))


def test_cpu_tensors_take_the_plain_version_and_bad_inputs_raise():
    x = torch.randn(64, dtype=torch.float64)
    before = fma_chain.launches
    assert torch.equal(fma_chain(x, 10), fma_chain_plain(x, 10))
    assert fma_chain.launches == before  # a CPU call launches nothing
    with pytest.raises(TypeError):
        fma_chain(torch.ones(4, dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        fma_chain(x, -1)
    with pytest.raises(ValueError):
        fma_chain(torch.empty(4, device="meta"), 3)


def test_block_threads_gives_one_block_an_sm():
    assert block_threads(2048, 132) == 32  # 64 blocks of one warp
    assert block_threads(16384, 132) == 128
    assert block_threads(132 * 32 * 16, 132) == 512
    assert block_threads(10**7, 132) == 1024
    assert block_threads(1, 132) == 32


# ---------------------------------------------------------------------- #
# on a CUDA card: the kernel against its plain version
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [
    lambda sm: 16384,  # the JAX script's count (128-thread blocks on 132 SMs)
    lambda sm: 2048,  # one warp a block
    lambda sm: 1000,  # a partial last block
    lambda sm: 1024 * sm,  # 1024-thread blocks: 32 warps an SM
    lambda sm: 1024 * sm - 100,  # 1024-thread blocks, a partial last one
], ids=["16384", "2048", "1000", "32-warps-an-sm", "32-warps-partial"])
def test_kernel_equals_plain_on_card(cuda, n):
    n = n(torch.cuda.get_device_properties(cuda).multi_processor_count)
    gen = torch.Generator(cuda).manual_seed(n)
    iters = 2000
    for dtype in (torch.float32, torch.float64):
        x = torch.randn(n, generator=gen, dtype=dtype, device=cuda)
        before = fma_chain.launches
        out = fma_chain(x, iters)
        torch.cuda.synchronize()
        assert fma_chain.launches == before + 1
        ref = fma_chain_plain(x.double(), iters)
        err = (out.double() - ref).abs()
        if dtype == torch.float64:
            assert bool((err <= 1e-9 * ref.abs()).all())
        else:
            assert float(err.max()) <= 2e-3 * float(ref.abs().max())
