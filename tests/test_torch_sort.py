"""The sort op (``ops/sort.py``): its plain versions against the JAX
package's Pallas sort kernels (interpret mode on the CPU) and against JAX's
stable XLA sort, the CPU routing and the launch counters; and, on a CUDA
card, the kernel against its plain version.

Every comparison is exact (``np.testing.assert_array_equal`` /
``torch.equal``).  The Pallas network is unstable on ties, so it is held to
tie-free keys; keys with ties and -0.0 / +0.0 are held against
``jnp.argsort`` and ``lax.sort_key_val``, which are stable.

JAX is imported inside the tests that compare with it, so that the
``cuda`` cases also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_sort.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from mind_the_gaps_tpu_torch.ops import (  # noqa: E402
    rank_remap,
    rank_remap_plain,
    sort_kv,
    sort_kv_plain,
)
from mind_the_gaps_tpu_torch.ops.sort import (  # noqa: E402
    MAX_CLUSTER,
    MAX_TILE,
    MIN_TILE,
    TIERS,
    padded_length,
    sort_tier,
)


def _unique_keys(rng, B, m):
    return rng.permutation(B * m).reshape(B, m).astype(np.float32)


def _tied_keys(rng, B, m):
    """Keys from a few values, with -0.0 and +0.0 among them."""
    vals = np.array([-1.5, -0.0, 0.0, 0.0, -0.0, 2.0, 2.0, 3.25], dtype=np.float32)
    return vals[rng.integers(0, len(vals), (B, m))]


def _hbm_call(make, m, C, B, n_out):
    """A Pallas call of an HBM-tier constructor at a test-sized geometry
    (the private-constructor pattern of tests/test_pallas_sort.py)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from mind_the_gaps_tpu.ops.pallas_sort import _LANES

    return pl.pallas_call(
        make(m, C, 64),
        out_shape=(jax.ShapeDtypeStruct((m, B), jnp.float32),) * n_out,
        grid=(B // _LANES,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_specs=(pl.BlockSpec(memory_space=pl.ANY),) * n_out,
        scratch_shapes=[
            pltpu.VMEM((2, C, _LANES), jnp.float32),
            pltpu.VMEM((2, C, _LANES), jnp.float32),
            pltpu.SemaphoreType.DMA((2, 2)),
        ],
        interpret=True,
    )


@pytest.mark.parametrize("m", [8, 64, 256])
def test_sort_kv_plain_matches_pallas_vmem_tier(m):
    pytest.importorskip("jax")
    from mind_the_gaps_tpu.ops.pallas_sort import bitonic_sort_kv

    rng = np.random.default_rng(m)
    k = _unique_keys(rng, 128, m)
    v = rng.normal(size=(128, m)).astype(np.float32)
    ks, vs = bitonic_sort_kv(k, v, interpret=True)
    out_k, out_v = sort_kv(torch.as_tensor(k), torch.as_tensor(v))
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(ks))
    np.testing.assert_array_equal(out_v.numpy(), np.asarray(vs))


def test_sort_kv_plain_matches_pallas_hbm_tier():
    jax = pytest.importorskip("jax")
    from mind_the_gaps_tpu.ops.pallas_sort import _make_hbm_kernel

    m, C, B = 1024, 256, 128
    rng = np.random.default_rng(3)
    k = _unique_keys(rng, B, m)
    v = rng.normal(size=(B, m)).astype(np.float32)
    with jax.enable_x64(False):
        ko, vo = _hbm_call(_make_hbm_kernel, m, C, B, 2)(k.T, v.T)
    out_k, out_v = sort_kv(torch.as_tensor(k), torch.as_tensor(v))
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(ko).T)
    np.testing.assert_array_equal(out_v.numpy(), np.asarray(vo).T)


def test_rank_remap_plain_matches_pallas_hbm_remap():
    jax = pytest.importorskip("jax")
    from mind_the_gaps_tpu.ops.pallas_sort import _make_hbm_remap_kernel

    m, C, B = 1024, 256, 128
    rng = np.random.default_rng(11)
    adj = _unique_keys(rng, B, m) * np.float32(0.01)
    draws = -np.sort(-rng.normal(size=(B, m)).astype(np.float32), axis=-1)
    with jax.enable_x64(False):
        _, permT, _, xnewT = _hbm_call(_make_hbm_remap_kernel, m, C, B, 4)(-adj.T, draws.T)
    perm, xnew = rank_remap(torch.as_tensor(adj), torch.as_tensor(draws))
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), np.asarray(permT).T.astype(np.int64))
    np.testing.assert_array_equal(xnew.numpy(), np.asarray(xnewT).T)


@pytest.mark.parametrize("m", [8, 100, 1000])
def test_plain_versions_match_jax_stable_sort_on_ties(m):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(m)
    k = _tied_keys(rng, 5, m)
    v = rng.normal(size=(5, m)).astype(np.float32)
    ks, vs = lax.sort_key_val(jnp.asarray(k), jnp.asarray(v), dimension=-1)
    out_k, out_v = sort_kv(torch.as_tensor(k), torch.as_tensor(v))
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(ks))
    np.testing.assert_array_equal(np.signbit(out_k.numpy()), np.signbit(np.asarray(ks)))
    np.testing.assert_array_equal(out_v.numpy(), np.asarray(vs))

    draws = -np.sort(-rng.normal(size=(5, m)).astype(np.float32), axis=-1)
    order = jnp.argsort(-jnp.asarray(k), axis=-1)
    _, xnew_ref = lax.sort_key_val(order, jnp.asarray(draws), dimension=-1)
    perm, xnew = rank_remap(torch.as_tensor(k), torch.as_tensor(draws))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(order))
    np.testing.assert_array_equal(xnew.numpy(), np.asarray(xnew_ref))


def test_cpu_tensors_use_the_plain_versions_and_do_not_count():
    rng = np.random.default_rng(0)
    k = torch.as_tensor(_tied_keys(rng, 3, 50))
    v = torch.as_tensor(rng.normal(size=(3, 50)))
    before = (sort_kv.launches, rank_remap.launches)
    for a, b in zip(sort_kv(k.double(), v), sort_kv_plain(k.double(), v)):
        assert torch.equal(a, b)
    for a, b in zip(rank_remap(k, v.float()), rank_remap_plain(k, v.float())):
        assert torch.equal(a, b)
    assert (sort_kv.launches, rank_remap.launches) == before


@pytest.mark.parametrize("m,dtype,tier,ctas", [
    (1, torch.float32, "tile", 1), (8, torch.float64, "tile", 1), (512, torch.float32, "tile", 1),
    (8192, torch.float64, "tile", 1), (16384, torch.float32, "tile", 1), (16384, torch.float64, "tile", 1),
    (16385, torch.float32, "cluster", 2), (50011, torch.float32, "cluster", 4),
    (65536, torch.float32, "cluster", 4), (65536, torch.float64, "cluster", 4),
    (65537, torch.float32, "cluster", 8), (131072, torch.float64, "cluster", 8),
    (131073, torch.float32, "two-level", 16), (131073, torch.float64, "two-level", 16),
    (1 << 20, torch.float32, "two-level", 64),
])
def test_sort_tier_documented_choices(m, dtype, tier, ctas):
    assert sort_tier(m, dtype) == (tier, ctas)


def test_tier_constants_match_the_kernel_source():
    src = (Path(__file__).resolve().parents[1] / "mind_the_gaps_tpu_torch/csrc/bitonic_sort.cu").read_text()
    assert f"constexpr int kMaxTile = {MAX_TILE};" in src
    assert f"constexpr int kMaxCluster = {MAX_CLUSTER};" in src
    assert "kLogE = sizeof(K) == 4 ? 4 : 5;" in src and "kMinTile = 32 * kE;" in src
    assert MIN_TILE == {torch.float32: 32 * 16, torch.float64: 32 * 32}


def test_sort_tier_selects_only_existing_tiers():
    for m in list(range(1, 600)) + [2**e + d for e in range(9, 24) for d in (-1, 0, 1)]:
        for dtype, warp_elems in ((torch.float32, 512), (torch.float64, 1024)):
            n = padded_length(m, dtype)
            assert n >= max(m, warp_elems) and n & (n - 1) == 0 and n < 2 * max(m, warp_elems)
            tier, ctas = sort_tier(m, dtype)
            assert tier in TIERS and ctas * min(n, MAX_TILE) == n
            assert (tier == "tile") == (ctas == 1) and (tier != "cluster" or ctas <= 8)
    with pytest.raises(ValueError):
        sort_tier(0)
    with pytest.raises(ValueError):
        sort_tier(8, torch.int32)


def test_bad_arguments_raise():
    k = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        sort_kv(k, torch.zeros(3, 9))
    with pytest.raises(ValueError):
        sort_kv(torch.zeros(8), torch.zeros(8))
    with pytest.raises(TypeError):
        sort_kv(k, k.double())
    with pytest.raises(TypeError):
        rank_remap(k.double(), k.double())
    with pytest.raises(ValueError):
        rank_remap(torch.empty(3, 8, device="meta"), torch.empty(3, 8, device="meta"))


# ---------------------------------------------------------------------- #
# on a CUDA card: the kernel against its plain version
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


CARD_CASES = [
    # B, m, keys: every tier (sort_kv also in float64), ragged lengths, the extremes
    (1, 1, "unique"),
    (3, 8, "ties"),
    (130, 100, "ties"),
    (7, 8192, "unique"),
    (4, 16384, "ties"),
    (3, 16385, "unique"),
    (2, 50011, "ties"),
    (2, 65536, "unique"),
    (1, 131072, "ties"),
    (4, 32768, "ties"),  # the cluster tier's edges: 2, 4 and 8 CTAs a row
    (128, 65536, "unique"),  # the lognormal main path's shape
    (3, 131072, "unique"),
    (2, 131073, "ties"),  # the first two-level row
]


def _card_keys(kind, B, m, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return _tied_keys(rng, B, m)
    return rng.normal(size=(B, m)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,kind", CARD_CASES)
def test_sort_kv_kernel_equals_plain_on_card(cuda, B, m, kind):
    k = torch.as_tensor(_card_keys(kind, B, m, m), device=cuda)
    v = torch.randn(B, m, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    before = sort_kv.launches
    out = sort_kv(k, v)
    torch.cuda.synchronize()
    assert sort_kv.launches == before + 1
    ref = sort_kv_plain(k, v)
    assert torch.equal(out[0], ref[0]) and torch.equal(torch.signbit(out[0]), torch.signbit(ref[0]))
    assert torch.equal(out[1], ref[1])
    out64 = sort_kv(k.double(), v.double())
    ref64 = sort_kv_plain(k.double(), v.double())
    assert torch.equal(out64[0], ref64[0]) and torch.equal(out64[1], ref64[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,kind", CARD_CASES)
def test_rank_remap_kernel_equals_plain_on_card(cuda, B, m, kind):
    adj = torch.as_tensor(_card_keys(kind, B, m, m + 1), device=cuda)
    draws = -torch.sort(-torch.randn(B, m, device=cuda), dim=-1).values
    before = rank_remap.launches
    perm, xnew = rank_remap(adj, draws)
    torch.cuda.synchronize()
    assert rank_remap.launches == before + 1
    ref_perm, ref_x = rank_remap_plain(adj, draws)
    assert torch.equal(perm, ref_perm) and torch.equal(xnew, ref_x)


@pytest.mark.cuda
def test_nan_and_inf_keys_sort_like_torch_on_card(cuda):
    k = torch.tensor([[float("nan"), 1.0, float("inf"), -float("inf"), -0.0, float("nan"), 0.0, 1.0]] * 3,
                     device=cuda)
    v = torch.arange(24, dtype=torch.float32, device=cuda).reshape(3, 8)
    out, ref = sort_kv(k, v), sort_kv_plain(k, v)
    assert torch.equal(out[1], ref[1])
    assert torch.equal(torch.isnan(out[0]), torch.isnan(ref[0]))
    perm, _ = rank_remap(k, v)
    assert torch.equal(perm, rank_remap_plain(k, v)[0])
