"""Legacy file readers.

The port's copy of ``mind_the_gaps_tpu/readingutils.py`` (numpy only),
itself a rebuild of reference mind_the_gaps/readingutils.py:12-257 (Swift
pipeline QDP products, catalog files, generic column files) without
astropy:
times in day-like columns are converted to seconds; the Swift zero point
is returned as MJD (float) rather than an astropy Time.
"""
from __future__ import annotations

import warnings

import numpy as np

__all__ = [
    "read_data",
    "read_data2",
    "read_zero_point",
    "readPCCURVE",
    "readPCUL",
    "readsimplePCCURVE",
    "readPCHR",
    "readPC_catalog",
    "read_best_fit",
    "read_standard_lightcurve",
]

_DAY_S = 86400.0


def read_data(input_file, tmin=0, tmax=np.inf):
    """Swift PCCURVE reader + time filter (reference readingutils.py:12-42).
    Returns (time_s, y, yerr, exposures, bkg_counts, bkg_rate_err)."""
    try:
        data = readPCCURVE(input_file, minSNR=0, minSigma=0, minCts=0)
    except ValueError:
        data = readsimplePCCURVE(input_file, minSigma=0)

    names = data.dtype.names
    time_column = names[0]
    rate_column = names[3]
    bkg_rate_err = names[8]
    corr_factor_column = names[9]
    bkg_counts_column = names[11]
    exposure_column = names[12]
    filtered = data[(data[time_column] >= tmin) & (data[time_column] <= tmax)]
    time = np.asarray(filtered[time_column], dtype=float)
    if time_column == "MJD":
        time = time * _DAY_S
    y = filtered[rate_column]
    yerr = (-filtered["%sneg" % rate_column] + filtered["%spos" % rate_column]) / 2
    exposures = filtered[exposure_column]
    bkg_err = filtered[bkg_rate_err]
    bkg_counts = filtered[bkg_counts_column]
    corr = filtered[corr_factor_column]
    return time, y, yerr, exposures / corr, bkg_counts, bkg_err * corr


def read_data2(input_file, tmin=0, tmax=np.inf):
    """Generic tab-separated reader (reference readingutils.py:45-80)."""
    data = np.genfromtxt(input_file, names=True, delimiter="\t")
    names = data.dtype.names
    time_column, rate_column, err_column, exposure_column = names[:4]
    filtered = data[(data[time_column] >= tmin) & (data[time_column] <= tmax)]
    time = np.asarray(filtered[time_column], dtype=float)
    if time_column.lower() in ["mjd", "jd", "day"]:
        time = time * _DAY_S
    y = filtered[rate_column]
    yerr = filtered[err_column]
    exposures = filtered[exposure_column]
    if len(names) > 4:
        bkg_counts = filtered[names[4]] * exposures
        bkg_rate_err = filtered[names[5]]
    else:
        warnings.warn("No background count-rates found! Assuming 0s everywhere")
        bkg_counts = np.zeros(len(filtered))
        bkg_rate_err = np.zeros(len(filtered))
    return time, y, yerr, exposures, bkg_counts, bkg_rate_err


def read_zero_point(file="t0.date"):
    """Swift MJD zero point from the pipeline's t0.date
    (reference readingutils.py:83-101).  Returns the MJD as float."""
    with open(file) as f:
        lines = f.readlines()
    return float(lines[2])


def readPCCURVE(file="PCCURVE.qdp", minExposure=0, minSigma=0, minSNR=0, minCts=0):
    """Swift pipeline PCCURVE.qdp (reference readingutils.py:104-132)."""
    try:
        data = np.genfromtxt(
            file, names=True, delimiter="\t", skip_header=2, comments="!",
            dtype=("f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, i8, f8, f8, f8, f8, U30"),
        )
    except ValueError:
        data = np.genfromtxt(
            file, names=True, delimiter="\t", skip_header=2, comments="!",
            dtype=("f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, i8, f8, f8, f8, f8"),
        )
    return data[
        (data["Exposure"] > minExposure)
        & (data["SNR"] > minSNR)
        & (data["Sigma"] > minSigma)
        & (data["CtsInSrc"] >= minCts)
    ]


def readPCUL(file="PCUL.qdp", minExposure=0):
    """Swift pipeline upper limits (reference readingutils.py:135-162)."""
    try:
        data = np.genfromtxt(
            file, names=True, delimiter="\t", skip_header=2, comments="!",
            dtype=("f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, i8, f8, f8, f8, f8, U30"),
        )
    except ValueError:
        data = np.genfromtxt(
            file, names=True, delimiter="\t", skip_header=2, comments="!",
            dtype=("f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, i8, f8, f8, f8, f8"),
        )
    if len(np.atleast_1d(data)) == 1:
        data = np.array([data])
    return data[(data["Exposure"] > minExposure)]


def readsimplePCCURVE(file="PCCURVE.qdp", minExposure=0, minSigma=0, minSNR=0):
    """Simple Swift-XRT proposal files (reference readingutils.py:165-180)."""
    data = np.genfromtxt(
        file, names=True, delimiter="\t", comments="!",
        dtype=("f8, f8, f8, f8, f8, f8"), deletechars="~", usecols=(0, 1, 2, 3, 4, 5),
    )
    return data[((data["T_+ve"] - data["T_-ve"]) > minExposure) & (data["Sigma"] > minSigma)]


def readPCHR(file="PCHR.qdp", minSoftSig=0, minHardSig=0, reject_errors=True, minExposure=0):
    """Swift hardness ratios (reference readingutils.py:183-208)."""
    try:
        data = np.genfromtxt(
            file, names=True, delimiter="\t", skip_header=2, comments="!",
            dtype=("f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, U30"),
        )
    except ValueError:
        data = np.genfromtxt(
            file, names=True, delimiter="\t", skip_header=2, comments="!",
            dtype=("f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, f8, f8"),
        )
    base = (
        (~np.isnan(data["HR"]))
        & (data["HR"] > 0)
        & (data["SoftSig"] > minSoftSig)
        & (data["HardSig"] > minHardSig)
        & (data["Exposure"] > minExposure)
    )
    if reject_errors:
        base = base & (data["HRerr"] < data["HR"])
    return data[base]


def readPC_catalog(file="PC_catalog.qdp", minExposure=0):
    """Swift LSXPS catalog lightcurves (reference readingutils.py:211-227)."""
    data = np.genfromtxt(
        file,
        names=["Time", "T_ve", "T_ve_1", "Rate", "Ratepos", "Rateneg"],
        delimiter="\t", skip_header=2, comments="!", dtype=("f8, f8, f8, f8, f8, f8"),
    )
    exposure = data["T_ve"] - data["T_ve_1"]
    return data[exposure > minExposure]


def read_best_fit(file):
    """Two-column best-fit files (reference readingutils.py:230-240)."""
    return np.genfromtxt(file, names=True, delimiter="\t", comments="#", dtype=("f8, f8"))


def read_standard_lightcurve(input_file):
    """The to_csv column layout: t, rate, error, exposure, bkg_counts,
    bkg_rate_err (reference readingutils.py:243-257).  Times in seconds."""
    lightcurve = np.genfromtxt(input_file, names=True)
    return (
        lightcurve["t"],
        lightcurve["rate"],
        lightcurve["error"],
        lightcurve["exposure"],
        lightcurve["bkg_counts"] if "bkg_counts" in lightcurve.dtype.names else lightcurve["bkg_rate"],
        lightcurve["bkg_rate_err"],
    )
