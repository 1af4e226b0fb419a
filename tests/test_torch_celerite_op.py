"""The celerite op: its plain version against the JAX package's Pallas
kernel (interpret mode on the CPU), the float32 contract, the CPU routing
and the launch counters; and, on a CUDA card, the kernel (its packed and
its dense-S body) against its plain version.

Also the wrapper's pure-Python rules (the layout ``team_size``, the
kernel's compile-time widths, the argument checks) and the order of the
sums (``chunk_sums``) that the kernel and its plain version share.

Tolerances: float64 rtol 1e-10; float32 rtol 1e-4, atol 1e-2 (those of
tests/test_pallas_grouped.py); float32 against float64 within 0.5 in
absolute log-likelihood (docs/PARITY.md, the f32 fast path contract).

JAX is imported inside the tests that compare with it, so that the
``cuda`` cases also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_celerite_op.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import math  # noqa: E402
import re  # noqa: E402
from pathlib import Path  # noqa: E402

import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu_torch.ops import (  # noqa: E402
    celerite_log_likelihood,
    celerite_log_likelihood_plain,
)
from mind_the_gaps_tpu_torch.ops.celerite import (  # noqa: E402
    LANE_LAYOUT_MIN_PER_SM,
    STATIC_WIDTHS,
    TEAMS,
    WARP_TEAM_MAX_PER_SM,
    _launch,
    check_coefficients,
    layouts,
    team_size,
)
from mind_the_gaps_tpu_torch.solver.batched import CHUNK, chunk_sums  # noqa: E402

B = 128  # the Pallas kernel needs B % 128 == 0
N = 77  # ragged: not a multiple of the kernel's time block or of 8


def _kernel(m, jr, jc):
    terms = [m.RealTerm(0.5 - 0.3 * i, -1.0 - 0.5 * i) for i in range(jr)]
    terms += [m.Lorentzian(-1.0 + 0.2 * i, 2.0 - 0.5 * i, -2.0 + 0.4 * i) for i in range(jc)]
    k = terms[0]
    for x in terms[1:]:
        k = k + x
    return k


def _case(jr, jc, layout, dtype, seed=0, n=N):
    """Coefficients, data, mean and jitter: the port's inputs, and the
    same numbers as numpy arrays for the JAX package."""
    rng = np.random.default_rng(seed)
    kt = _kernel(tk, jr, jc)
    th = kt.get_parameter_vector() + 0.05 * rng.normal(size=(B, kt.ndim))
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    if layout == "shared":
        y, d, repeats = rng.normal(0, 2, n), np.full(n, 0.09), 1
    elif layout == "grouped":
        y, d, repeats = rng.normal(0, 2, (16, n)), rng.uniform(0.05, 0.1, (16, n)), 8
    else:  # per-element series with a shared diagonal
        y, d, repeats = rng.normal(0, 2, (B, n)), np.full(n, 0.09), 1
    mean = rng.normal(0, 0.2, B)
    jit = rng.uniform(0.0, 0.02, B)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    numpy_in = dict(th=th.astype(np_dt), t=t, y=y.astype(np_dt), diag=d.astype(np_dt),
                    mean=mean.astype(np_dt), repeats=repeats, extra_diag=jit.astype(np_dt))
    torch_in = dict(
        coeffs=kt.coefficients(torch.as_tensor(th, dtype=dtype)), t=torch.as_tensor(t),
        y=torch.as_tensor(y, dtype=dtype), diag=torch.as_tensor(d, dtype=dtype),
        mean=torch.as_tensor(mean, dtype=dtype), repeats=repeats,
        extra_diag=torch.as_tensor(jit, dtype=dtype),
    )
    return numpy_in, torch_in


CASES = [
    (1, 0, "shared", torch.float64),
    (0, 1, "grouped", torch.float64),
    (1, 1, "per", torch.float64),
    (0, 2, "shared", torch.float64),
    (1, 2, "grouped", torch.float64),
    (6, 0, "per", torch.float64),
    (0, 3, "grouped", torch.float64),
    (1, 3, "grouped", torch.float64),  # R = 7: DRW + 3 Lorentzians
    (3, 3, "per", torch.float64),  # R = 9: the kernel's runtime-R body
    (1, 0, "grouped", torch.float32),
    (1, 1, "shared", torch.float32),
]


@pytest.mark.parametrize("jr,jc,layout,dtype", CASES)
def test_plain_matches_pallas_interpret(jr, jc, layout, dtype):
    jax = pytest.importorskip("jax")
    import mind_the_gaps_tpu.kernels as jk
    from mind_the_gaps_tpu.ops.pallas_celerite import pallas_log_likelihood

    x, torch_in = _case(jr, jc, layout, dtype)
    ref = np.asarray(pallas_log_likelihood(
        jax.vmap(_kernel(jk, jr, jc).coefficients)(x["th"]), x["t"], x["y"], x["diag"],
        mean=x["mean"], repeats=x["repeats"], extra_diag=x["extra_diag"], interpret=True,
    ))
    out = celerite_log_likelihood(**torch_in)
    assert out.dtype == dtype and out.shape == (B,)
    assert np.all(np.isfinite(ref))
    if dtype == torch.float64:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-2)


def test_f32_tracks_f64_long_baseline():
    """t ~ 5e7 s: dt is formed in float64 before the cast, so float32
    keeps the gaps (the JAX package's long-baseline case)."""
    kt = tk.DampedRandomWalk(1.0, np.log(2e-6)) + tk.Lorentzian(-1.0, 2.0, np.log(1e-5))
    rng = np.random.default_rng(3)
    n = 2000
    t = 5e7 + np.cumsum(rng.uniform(2e4, 1e5, n))
    y = rng.normal(0.0, 2.0, n)
    th = kt.get_parameter_vector() + 0.05 * rng.normal(size=(4, 5))
    out = {}
    for dt in (torch.float64, torch.float32):
        out[dt] = celerite_log_likelihood(
            kt.coefficients(torch.as_tensor(th, dtype=dt)), torch.as_tensor(t),
            torch.as_tensor(y, dtype=dt), torch.full((n,), 0.09, dtype=dt),
        ).double().numpy()
    assert np.all(np.isfinite(out[torch.float64]))
    assert np.max(np.abs(out[torch.float64] - out[torch.float32])) < 0.5


def test_cpu_tensors_use_the_plain_version_and_do_not_count():
    _, torch_in = _case(1, 1, "grouped", torch.float64, seed=5, n=20)
    before = (celerite_log_likelihood.launches, celerite_log_likelihood.dense_launches)
    out = celerite_log_likelihood(**torch_in)
    dense = celerite_log_likelihood(**torch_in, sym=False)
    assert (celerite_log_likelihood.launches, celerite_log_likelihood.dense_launches) == before
    torch.testing.assert_close(out, celerite_log_likelihood_plain(**torch_in), rtol=0, atol=0)
    torch.testing.assert_close(dense, out, rtol=0, atol=0)


def test_non_pd_and_bad_layouts():
    _, torch_in = _case(1, 0, "shared", torch.float64, seed=6, n=20)
    c = torch_in["coeffs"]
    torch_in["coeffs"] = c._replace(ar=c.ar.clone().index_fill_(0, torch.tensor([0, 1]), -100.0))
    out = celerite_log_likelihood(**torch_in).numpy()
    assert out[0] == out[1] == -np.inf and np.all(np.isfinite(out[2:]))
    with pytest.raises(ValueError):
        celerite_log_likelihood(**{**torch_in, "y": torch.zeros(3, 20, dtype=torch.float64), "repeats": 8})
    with pytest.raises(ValueError):
        meta = torch_in["coeffs"]._replace(ar=torch.empty((B, 1), device="meta", dtype=torch.float64))
        celerite_log_likelihood(**{**torch_in, "coeffs": meta})


H100_SMS = 132


@pytest.mark.parametrize("B,jr,jc,team", [
    (1, 1, 1, 32),
    (16, 1, 1, 32),  # the observed sampler
    (513, 1, 1, 32),  # the float64 refine
    (WARP_TEAM_MAX_PER_SM * H100_SMS, 1, 0, 32),
    (WARP_TEAM_MAX_PER_SM * H100_SMS + 1, 1, 0, 8),
    (16 * H100_SMS, 2, 1, 8),
    (100_000, 2, 1, 1),  # above the one-thread crossover
    (3078, 1, 1, 8),  # the bootstrap refits
    (3078, 3, 3, 32),  # the runtime-R body has the warp layout only
])
def test_team_size_documented_choices(B, jr, jc, team):
    assert team_size(B, H100_SMS, jr, jc) == team


@pytest.mark.parametrize("B,sym,team", [
    (LANE_LAYOUT_MIN_PER_SM * H100_SMS, True, 1),  # at the crossover
    (LANE_LAYOUT_MIN_PER_SM * H100_SMS + 1, True, 1),
    (LANE_LAYOUT_MIN_PER_SM * H100_SMS - 1, True, 8),  # just below it
    (65_536, True, 1),  # the bench's primary batch
    (65_536, False, 8),  # the dense-S body keeps the teams
    (LANE_LAYOUT_MIN_PER_SM * H100_SMS, False, 8),
    (16, False, 32),
])
def test_team_size_one_thread_crossover(B, sym, team):
    assert team_size(B, H100_SMS, 1, 1, sym) == team


@pytest.mark.parametrize("jr,jc,sym,have", [
    (1, 1, True, (32, 8, 1)),
    (2, 3, True, (32, 8, 1)),
    (1, 1, False, (32, 8)),
    (3, 3, True, (32,)),  # R = 9: the runtime-R body
    (3, 3, False, (32,)),
])
def test_layouts_of_each_body(jr, jc, sym, have):
    assert layouts(jr, jc, sym) == have
    assert team_size(65_536, H100_SMS, jr, jc, sym) in have


@pytest.mark.parametrize("jr,jc,sym,team", [
    (1, 1, True, 4),  # not a layout of TEAMS
    (1, 1, True, 16),
    (1, 1, False, 1),  # the dense-S body has no one-thread layout
    (3, 3, True, 8),  # the runtime-R body has the warp only
    (3, 3, True, 1),
])
def test_launch_refuses_a_layout_the_body_lacks(jr, jc, sym, team):
    """The refusal comes before any device work (here on CPU tensors)."""
    assert set(TEAMS) == {32, 8, 1}
    _, torch_in = _case(jr, jc, "shared", torch.float64, n=8)
    with pytest.raises(ValueError, match="team must be one of"):
        _launch(**torch_in, sym=sym, team=team)


@pytest.mark.parametrize("layout,B", [("grouped", 18), ("shared", 7)])
def test_layout_sweep_inputs_and_head_rows(layout, B):
    """The sweep's inputs and the first rows it holds against the plain
    version: the plain version on the head equals its first rows on all."""
    from mind_the_gaps_tpu_torch.ops.layout_sweep import _head, inputs

    args = inputs(B, layout, torch.float64, device="cpu", n=40)
    assert args["repeats"] == (6 if layout == "grouped" else 1)
    assert tuple(args["y"].shape) == ((B // 6, 40) if layout == "grouped" else (40,))
    m = 6
    full = celerite_log_likelihood_plain(**args)
    torch.testing.assert_close(celerite_log_likelihood_plain(**_head(args, m)), full[:m], rtol=0, atol=0)


def test_team_size_selects_only_existing_bodies():
    for sms in (1, 66, 132):
        for B in (1, 2, 31, 32, 33, 100, 263, 264, 265, 528, 529, 1000, 3078, 12_294, 65_536, 100_000):
            for jr in range(9):
                for jc in range(6):
                    if jr + 2 * jc == 0:
                        continue
                    for sym in (True, False):
                        team = team_size(B, sms, jr, jc, sym)
                        assert team in layouts(jr, jc, sym)
                        if team != 32:  # only the compile-time bodies have these
                            assert (jr, jc) in STATIC_WIDTHS


def test_static_widths_match_the_kernel_source():
    src = (Path(__file__).resolve().parents[1] / "mind_the_gaps_tpu_torch/csrc/celerite_loglike.cuh").read_text()
    block = src[src.index("#define CELERITE_STATIC_PAIRS"):]
    block = block[:block.index("\n\n")]
    pairs = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", block)}
    assert pairs == set(STATIC_WIDTHS)
    assert all(1 <= jr + 2 * jc <= 8 for jr, jc in pairs)
    assert {(jr, jc) for jr in range(7) for jc in range(4) if 1 <= jr + 2 * jc <= 6} <= pairs


@pytest.mark.parametrize("jr,jc", [(1, 3), (0, 4), (7, 0), (3, 3), (2, 4), (12, 0)])
def test_argument_checks_take_any_width(jr, jc):
    """R >= 7 passes the checks the wrapper runs before a launch."""
    coeffs = _kernel(tk, jr, jc).coefficients(torch.zeros(5, 2 * jr + 3 * jc, dtype=torch.float64))
    assert check_coefficients(coeffs) == (5, jr, jc)


def test_argument_checks_refuse_no_term_and_mixed_dtypes():
    coeffs = tk.DampedRandomWalk(1.0, -3.0).coefficients(torch.zeros(5, 2, dtype=torch.float64))
    empty = torch.zeros(5, 0, dtype=torch.float64)
    with pytest.raises(ValueError):
        check_coefficients(type(coeffs)(empty, empty, *coeffs[2:]))
    with pytest.raises(ValueError):
        check_coefficients(coeffs._replace(cr=coeffs.cr.float()))
    with pytest.raises(TypeError):
        check_coefficients(type(coeffs)(*(c.half() for c in coeffs)))


@pytest.mark.parametrize("n", [1, 5, CHUNK, CHUNK + 1, 3 * CHUNK - 7])
def test_chunk_sums_order(n):
    """Chunks of 32 steps, zero-padded, each a pairwise tree of neighbours,
    then Kahan across chunks: the kernel's order, written out by hand."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3)) * 10.0 ** rng.integers(-8, 8, size=(n, 3))
    pad = np.concatenate([x, np.zeros(((-n) % CHUNK, 3))])
    sums, comp = np.zeros(3), np.zeros(3)
    for c in range(pad.shape[0] // CHUNK):
        level = list(pad[c * CHUNK:(c + 1) * CHUNK])
        while len(level) > 1:
            level = [level[i] + level[i + 1] for i in range(0, len(level), 2)]
        yk = level[0] - comp
        tk_ = sums + yk
        comp = (tk_ - sums) - yk
        sums = tk_
    np.testing.assert_array_equal(chunk_sums(torch.as_tensor(x)).numpy(), sums)
    np.testing.assert_allclose(sums, [math.fsum(col) for col in x.T], rtol=1e-12, atol=1e-300)


def test_plain_matches_jax_solver_at_n5000():
    """The chunked sums at the main path's length: float64 against the JAX
    package's f64 scan (rtol 1e-10), float32 within 0.5 of float64."""
    jax = pytest.importorskip("jax")
    import mind_the_gaps_tpu.kernels as jk
    from mind_the_gaps_tpu.solver import log_likelihood as j_loglike

    rng = np.random.default_rng(11)
    n = 5000
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    y = 10.0 + rng.normal(0.0, 2.0, n)
    kt, kj = (m.DampedRandomWalk(1.0, -3.0) + m.Lorentzian(-1.0, 2.0, -2.0) for m in (tk, jk))
    th = kt.get_parameter_vector() + 0.05 * rng.normal(size=(3, 5))
    ref = np.array([float(jax.jit(j_loglike)(kj.coefficients(jax.numpy.asarray(x)), t, y, np.full(n, 0.09),
                                             10.0)) for x in th])
    out = {}
    for dt in (torch.float64, torch.float32):
        out[dt] = celerite_log_likelihood(
            kt.coefficients(torch.as_tensor(th, dtype=dt)), torch.as_tensor(t), torch.as_tensor(y, dtype=dt),
            torch.full((n,), 0.09, dtype=dt), mean=torch.full((3,), 10.0, dtype=dt),
        ).double().numpy()
    np.testing.assert_allclose(out[torch.float64], ref, rtol=1e-10)
    assert np.max(np.abs(out[torch.float32] - out[torch.float64])) < 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,layout,dtype", CASES)
def test_kernel_matches_plain_on_card(cuda, jr, jc, layout, dtype):
    _, torch_in = _case(jr, jc, layout, dtype, seed=7)
    on_card = {k: (v.to(cuda) if torch.is_tensor(v) else v) for k, v in torch_in.items()}
    on_card["coeffs"] = type(torch_in["coeffs"])(*(x.to(cuda) for x in torch_in["coeffs"]))
    before = celerite_log_likelihood.launches
    out = celerite_log_likelihood(**on_card)
    torch.cuda.synchronize()
    assert celerite_log_likelihood.launches == before + 1
    ref = celerite_log_likelihood_plain(**on_card)
    tol = dict(rtol=1e-10, atol=0.0) if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(out, ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,layout,dtype", CASES)
def test_dense_s_kernel_matches_plain_on_card(cuda, jr, jc, layout, dtype):
    """The dense-S body (``sym=False``) against the plain version."""
    _, torch_in = _case(jr, jc, layout, dtype, seed=8)
    on_card = {k: (v.to(cuda) if torch.is_tensor(v) else v) for k, v in torch_in.items()}
    on_card["coeffs"] = type(torch_in["coeffs"])(*(x.to(cuda) for x in torch_in["coeffs"]))
    before = celerite_log_likelihood.dense_launches
    out = celerite_log_likelihood(**on_card, sym=False)
    torch.cuda.synchronize()
    assert celerite_log_likelihood.dense_launches == before + 1
    ref = celerite_log_likelihood_plain(**on_card)
    tol = dict(rtol=1e-10, atol=0.0) if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(out, ref, **tol)


def _on_card(torch_in, cuda):
    on_card = {k: (v.to(cuda) if torch.is_tensor(v) else v) for k, v in torch_in.items()}
    on_card["coeffs"] = type(torch_in["coeffs"])(*(x.to(cuda) for x in torch_in["coeffs"]))
    return on_card


def _tol(dtype):
    return dict(rtol=1e-10, atol=0.0) if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,layout,dtype", [
    (1, 3, "grouped", torch.float32),  # R = 7, compile-time body
    (1, 3, "per", torch.float64),
    (2, 4, "shared", torch.float64),  # R = 10, runtime-R body
    (2, 4, "grouped", torch.float32),
])
def test_wide_kernels_match_plain_on_card(cuda, jr, jc, layout, dtype):
    on_card = _on_card(_case(jr, jc, layout, dtype, seed=9)[1], cuda)
    ref = celerite_log_likelihood_plain(**on_card)
    for sym in (True, False):
        torch.testing.assert_close(celerite_log_likelihood(**on_card, sym=sym), ref, **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 1056, 3078])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_both_layouts_match_plain_at_n5000_on_card(cuda, B, dtype):
    """B on either side of the layout crossover, the rule's layout and both
    forced ones, at the main path's N = 5000."""
    kt = tk.DampedRandomWalk(1.0, -3.0) + tk.Lorentzian(-1.0, 2.0, -2.0)
    rng = np.random.default_rng(B)
    n = 5000
    th = kt.get_parameter_vector() + 0.05 * rng.normal(size=(B, 5))
    args = dict(coeffs=kt.coefficients(torch.as_tensor(th, dtype=dtype, device=cuda)),
                t=torch.as_tensor(np.cumsum(rng.uniform(2.0, 8.0, n)), device=cuda),
                y=torch.as_tensor(10.0 + rng.normal(0.0, 2.0, n), dtype=dtype, device=cuda),
                diag=torch.full((n,), 0.09, dtype=dtype, device=cuda),
                mean=torch.full((B,), 10.0, dtype=dtype, device=cuda))
    ref = celerite_log_likelihood_plain(**args)
    for team in (None, *TEAMS):
        torch.testing.assert_close(_launch(**args, team=team), ref, **_tol(dtype))


@pytest.mark.cuda
def test_f32_tracks_f64_long_baseline_on_card(cuda):
    kt = tk.DampedRandomWalk(1.0, np.log(2e-6)) + tk.Lorentzian(-1.0, 2.0, np.log(1e-5))
    rng = np.random.default_rng(3)
    n = 5000
    t = torch.as_tensor(5e7 + np.cumsum(rng.uniform(2e4, 1e5, n)), device=cuda)
    y = rng.normal(0.0, 2.0, n)
    th = kt.get_parameter_vector() + 0.05 * rng.normal(size=(16, 5))
    out = {}
    for dt in (torch.float64, torch.float32):
        out[dt] = celerite_log_likelihood(
            kt.coefficients(torch.as_tensor(th, dtype=dt, device=cuda)), t,
            torch.as_tensor(y, dtype=dt, device=cuda), torch.full((n,), 0.09, dtype=dt, device=cuda),
        ).double()
    assert bool(torch.all(torch.isfinite(out[torch.float64])))
    assert float((out[torch.float64] - out[torch.float32]).abs().max()) < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc", [(1, 0), (1, 1), (2, 4)])
def test_non_pd_gives_minus_inf_from_every_layout_on_card(cuda, jr, jc):
    _, torch_in = _case(jr, jc, "shared", torch.float64, seed=6, n=300)
    c = torch_in["coeffs"]
    torch_in["coeffs"] = c._replace(ar=c.ar.clone().index_fill_(0, torch.tensor([0, 1]), -100.0))
    on_card = _on_card(torch_in, cuda)
    outs = [_launch(**on_card, sym=sym, team=team) for sym in (True, False) for team in layouts(jr, jc, sym)]
    for out in outs:
        out = out.cpu().numpy()
        assert out[0] == out[1] == -np.inf and np.all(np.isfinite(out[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,dtype", [("shared", torch.float64), ("grouped", torch.float32),
                                          ("per", torch.float64), ("shared", torch.float32)])
@pytest.mark.parametrize("jr,jc", [(1, 0), (1, 1), (0, 2), (2, 3)])
def test_one_thread_layout_matches_plain_and_teams_on_card(cuda, jr, jc, layout, dtype):
    """L = 1 against the plain version (the tolerances above, the same -inf
    rows) and against the 8-lane layout, which runs the same operations in
    the same order: equal within the tolerance, and counted when the bits
    differ."""
    _, torch_in = _case(jr, jc, layout, dtype, seed=12)
    c = torch_in["coeffs"]
    if jr:
        torch_in["coeffs"] = c._replace(ar=c.ar.clone().index_fill_(0, torch.tensor([3]), -100.0))
    on_card = _on_card(torch_in, cuda)
    ref = celerite_log_likelihood_plain(**on_card)
    before = celerite_log_likelihood.team_launches[1]
    one = _launch(**on_card, team=1)
    eight = _launch(**on_card, team=8)
    torch.cuda.synchronize()
    assert celerite_log_likelihood.team_launches[1] == before + 1
    assert torch.equal(torch.isfinite(one), torch.isfinite(ref))
    torch.testing.assert_close(one, ref, **_tol(dtype))
    torch.testing.assert_close(one, eight, **_tol(dtype))
