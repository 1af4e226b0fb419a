"""The port's file loaders, ``readingutils`` readers and C table parser
against the JAX package's, on the files of ``tests/test_loaders.py``.

Every loader and reader must give arrays equal to the JAX package's on the
same file (the same numpy parsing; ``np.testing.assert_array_equal``,
NaN equal to NaN), and the port's C parser must equal its own numpy path.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import mind_the_gaps_tpu as jpkg  # noqa: E402
import mind_the_gaps_tpu_torch as tpkg  # noqa: E402
from mind_the_gaps_tpu import readingutils as jread  # noqa: E402
from mind_the_gaps_tpu.io import fastio as jfastio  # noqa: E402
from mind_the_gaps_tpu.lightcurves.loaders import load_lightcurve_directory as j_load_dir  # noqa: E402
from mind_the_gaps_tpu_torch import readingutils as tread  # noqa: E402
from mind_the_gaps_tpu_torch.io import fastio  # noqa: E402
from mind_the_gaps_tpu_torch.lightcurves import load_lightcurve_directory  # noqa: E402

PCCURVE_HEADER = (
    "READ TERR 1 2\n!MJD\n"
    "MJD\tT_+ve\tT_-ve\tRate\tRatepos\tRateneg\tSNR\tBGrate\tBGerr\t"
    "CorrFact\tCtsInSrc\tBGInSrc\tExposure\tSigma\tSNR2\tObsID\n"
)


def _write_pccurve(path, n=10):
    rows = [
        f"{50000 + 2*i}\t0.5\t-0.5\t{1.0 + 0.05*i:.4f}\t0.1\t-0.1\t10.0\t0.01\t0.001\t"
        f"1.1\t{100+i}\t5.0\t1000.0\t8.0\t10.0\t000{i}"
        for i in range(n)
    ]
    path.write_text(PCCURVE_HEADER + "\n".join(rows))
    return str(path)


def _assert_lightcurves_equal(a, b):
    for name in ("times", "y", "dy", "exposures", "bkg_rate", "bkg_rate_err"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def _assert_records_equal(a, b):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    assert a.dtype.names == b.dtype.names and a.shape == b.shape
    for name in a.dtype.names:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _simple_files(tmp_path):
    rng = np.random.default_rng(0)
    files = {}
    f = tmp_path / "lc.csv"
    f.write_text("t\trate\terror\texposure\tbkg_rate\tbkg_rate_err\n" + "\n".join(
        f"{10.0*i:.1f}\t{1.0+0.1*i:.3f}\t0.05\t2.0\t0.01\t0.001" for i in range(20)))
    files["six columns"] = (str(f), {})
    f = tmp_path / "days.csv"
    f.write_text("mjd rate error\n" + "\n".join(f"{50000 + i} {1.0} {0.1}" for i in range(5)))
    files["days, three columns"] = (str(f), {})
    f = tmp_path / "four.dat"
    t = np.cumsum(rng.uniform(1, 3, 40))
    f.write_text("time rate error exposure\n" + "\n".join(f"{ti} {ri} 0.1 0.5" for ti, ri in zip(t, rng.normal(5, 1, 40))))
    files["four columns"] = (str(f), {})
    f = tmp_path / "comma.csv"
    f.write_text("t,rate,error\n" + "\n".join(f"{10.0*i:.1f},{1.0+0.1*i:.3f},0.05" for i in range(10)))
    files["explicit delimiter"] = (str(f), {"delimiter": ","})
    lc = tpkg.GappyLightcurve(np.cumsum(rng.uniform(5, 10, 30)), rng.normal(5, 1, 30), np.full(30, 0.3),
                              exposures=2.0, bkg_rate=np.full(30, 0.2), bkg_rate_err=np.full(30, 0.02))
    lc.to_csv(str(tmp_path / "to_csv.dat"))
    files["to_csv output"] = (str(tmp_path / "to_csv.dat"), {})
    return files


def test_simple_lightcurve_equals_jax(tmp_path):
    for name, (path, kw) in _simple_files(tmp_path).items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "no exposures" for the three-column files, in both
            a, b = tpkg.SimpleLightcurve(path, **kw), jpkg.SimpleLightcurve(path, **kw)
        assert isinstance(a, tpkg.GappyLightcurve), name
        _assert_lightcurves_equal(a, b)
    with pytest.warns(UserWarning):
        tpkg.SimpleLightcurve(_simple_files(tmp_path)["days, three columns"][0])


def test_load_lightcurve_directory_equals_jax(tmp_path):
    files = _simple_files(tmp_path)
    paths = [files[k][0] for k in ("six columns", "four columns", "to_csv output")]
    ours, ref = load_lightcurve_directory(paths, workers=3), j_load_dir(paths, workers=3)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        _assert_lightcurves_equal(a, b)


def test_swift_and_fermi_lightcurves_equal_jax(tmp_path):
    path = _write_pccurve(tmp_path / "PCCURVE.qdp")
    for kw in ({}, {"minCts": 105}, {"minSNR": 20}):
        _assert_lightcurves_equal(tpkg.SwiftLightcurve(path, **kw), jpkg.SwiftLightcurve(path, **kw))
    assert tpkg.SwiftLightcurve(path, minCts=105).n == 5
    simple = tmp_path / "simple.qdp"  # a Swift proposal file: six columns, no header rows to skip
    simple.write_text("Time\tT_+ve\tT_-ve\tRate\tRatepos\tSigma\n" + "\n".join(
        f"{1000.0 + 100 * i}\t5.0\t-5.0\t{0.3 + 0.01 * i}\t0.02\t{3.0 + i}" for i in range(6)))
    _assert_records_equal(tread.readsimplePCCURVE(str(simple), minSigma=4), jread.readsimplePCCURVE(str(simple),
                                                                                                    minSigma=4))
    f = tmp_path / "fermi.csv"
    f.write_text("mjd,flux,flux_err_neg,flux_err_pos\n" + "\n".join(f"{55000+i},{2.0+0.1*i},-0.2,0.4" for i in range(8)))
    _assert_lightcurves_equal(tpkg.FermiLightcurve(str(f)), jpkg.FermiLightcurve(str(f)))


def test_readingutils_equal_jax(tmp_path):
    path = _write_pccurve(tmp_path / "PCCURVE.qdp")
    for a, b in zip(tread.read_data(path, tmin=50004, tmax=50010), jread.read_data(path, tmin=50004, tmax=50010)):
        np.testing.assert_array_equal(a, b)
    for kw in ({}, {"minCts": 108}):
        _assert_records_equal(tread.readPCCURVE(path, **kw), jread.readPCCURVE(path, **kw))

    generic = tmp_path / "generic.dat"
    generic.write_text("mjd\trate\terror\texposure\tbkgrate\tbkgerr\n" + "".join(
        f"{100.0 + i}\t{1.0 + 0.2 * i}\t0.1\t500.0\t0.01\t0.001\n" for i in range(3)))
    for a, b in zip(tread.read_data2(str(generic), tmin=100.5), jread.read_data2(str(generic), tmin=100.5)):
        np.testing.assert_array_equal(a, b)

    t0 = tmp_path / "t0.date"
    t0.write_text("some header\nanother line\n55234.5\n")
    assert tread.read_zero_point(str(t0)) == jread.read_zero_point(str(t0)) == 55234.5

    ul = tmp_path / "PCUL.qdp"
    ul.write_text(PCCURVE_HEADER + "50000\t0.5\t-0.5\t0.05\t0.0\t0.0\t1.0\t0.01\t0.001\t1.1\t3\t1.0\t800.0\t1.0\t1.0\t0001")
    for kw in ({}, {"minExposure": 900}):
        _assert_records_equal(tread.readPCUL(str(ul), **kw), jread.readPCUL(str(ul), **kw))

    hr = tmp_path / "PCHR.qdp"
    hr.write_text(
        "READ TERR 1 2\n!MJD\nMJD\tT_+ve\tT_-ve\tHR\tHRerr\tHRneg\tSoftSig\tHardSig\tSoftRate\t"
        "HardRate\tSoftErr\tHardErr\tExposure\tObsID\n"
        "50000\t0.5\t-0.5\t0.8\t0.1\t-0.1\t5.0\t5.0\t1.0\t0.8\t0.1\t0.1\t1000.0\t0001\n"
        "50002\t0.5\t-0.5\t0.2\t0.5\t-0.5\t5.0\t5.0\t1.0\t0.2\t0.1\t0.1\t1000.0\t0002\n"
        "50004\t0.5\t-0.5\t-0.1\t0.1\t-0.1\t5.0\t5.0\t1.0\t0.1\t0.1\t0.1\t1000.0\t0003")
    for kw in ({}, {"reject_errors": False}):
        _assert_records_equal(tread.readPCHR(str(hr), **kw), jread.readPCHR(str(hr), **kw))

    cat = tmp_path / "PC_catalog.qdp"
    cat.write_text("READ TERR 1 2\n!catalog\n1000.0\t500.0\t-500.0\t1.0\t0.1\t-0.1\n"
                   "3000.0\t500.0\t-500.0\t1.2\t0.1\t-0.1\n5000.0\t100.0\t-100.0\t1.4\t0.1\t-0.1")
    _assert_records_equal(tread.readPC_catalog(str(cat), minExposure=300), jread.readPC_catalog(str(cat), minExposure=300))

    best = tmp_path / "best_fit.dat"
    best.write_text("parameter\tvalue\n1.0\t2.5\n2.0\t3.5\n")
    _assert_records_equal(tread.read_best_fit(str(best)), jread.read_best_fit(str(best)))

    std = _simple_files(tmp_path)["to_csv output"][0]
    for a, b in zip(tread.read_standard_lightcurve(std), jread.read_standard_lightcurve(std)):
        np.testing.assert_array_equal(a, b)


QDP = (
    b"! Swift-XRT data\nREAD TERR 1 2\n"
    b"!Time Tpos Tneg Rate Ratepos Rateneg\n"
    b"110.0 5.0 -5.0 0.31 0.02 -0.02\n"
    b"130.0 5.0 -5.0 NO 0.03 -0.03\n"
    b"150.0 5.0 -5.0 0.29 0.02 -0.02\n"
)
TABLES = {
    "qdp": QDP,
    "csv with header": b"mjd,rate,error\n55000.5,1.2,0.1\n55001.5,1.3,0.1\n",
    "ragged rows": b"1,2,3\n4,,6\n7,8,9\n",
    "comments and nan": b"# c\n; c\n% c\n1.5 nan 2\n,3 4 5\n\n6e-3 7 NaN\n",
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_fastio_native_equals_numpy_path(name):
    assert fastio.have_native()  # built into mind_the_gaps_tpu_torch/_build by the system compiler
    data = TABLES[name]
    native = fastio.parse_bytes(data)
    ref, _ = fastio._parse_numpy(data)
    assert native.shape == ref.shape and native.flags.writeable
    np.testing.assert_array_equal(native, ref)
    np.testing.assert_array_equal(native, jfastio.parse_bytes(data))


def test_fastio_files_and_build_place(tmp_path):
    p = tmp_path / "a.qdp"
    p.write_bytes(QDP)
    arr = fastio.load_table(str(p))
    assert arr.shape == (3, 6) and np.isnan(arr[1, 3])
    c = tmp_path / "b.csv"
    c.write_bytes(TABLES["csv with header"])
    cols = fastio.load_columns(str(c))
    assert list(cols) == ["mjd", "rate", "error"] and cols["rate"][1] == 1.3
    r = tmp_path / "ragged.csv"
    r.write_bytes(TABLES["ragged rows"])
    with pytest.warns(UserWarning, match="skipped"):
        assert fastio.load_table(str(r)).shape == (2, 3)
    outs = fastio.load_directory([str(p), str(c)], workers=2)
    np.testing.assert_array_equal(outs[0], arr)
    ext = fastio._ext_path()
    assert ext.parent.name == "_build" and ext.parent.parent.name == "mind_the_gaps_tpu_torch" and ext.exists()
