"""File-format loaders producing GappyLightcurve instances.

The port's copy of ``mind_the_gaps_tpu/lightcurves/loaders.py``: host
parsing (numpy, and the port's own C table parser ``io/fastio.py``) into
the port's ``GappyLightcurve``.  They replace the reference's loader
classes (simplelightcurve.py:12, swiftlightcurve.py:10,
fermilightcurve.py:11).  Day-unit columns are converted to seconds.
"""
from __future__ import annotations

import warnings

import numpy as np

from mind_the_gaps_tpu_torch.lightcurves.gappylightcurve import GappyLightcurve

__all__ = [
    "SimpleLightcurve",
    "SwiftLightcurve",
    "FermiLightcurve",
    "load_lightcurve_directory",
]

_DAY_S = 86400.0


def _simple_fields(names, columns):
    """(time, y, dy, exposures, bkg, bkg_err) from positional columns —
    the SimpleLightcurve layout (reference simplelightcurve.py:12-60)."""
    time = np.asarray(columns[0], dtype=float)
    if names[0].lower() in ["mjd", "jd", "day"]:
        time = time * _DAY_S
    y, yerr = columns[1], columns[2]
    if len(names) > 3:
        exposures = columns[3]
        if len(names) >= 6:
            bkg_rate, bkg_err = columns[4], columns[5]
        else:
            bkg_rate = np.zeros(len(time))
            bkg_err = np.zeros(len(time))
    else:
        warnings.warn("Lightcurve has no exposures!")
        exposures = np.zeros(len(time))
        bkg_rate = np.zeros(len(time))
        bkg_err = np.zeros(len(time))
    return time, y, yerr, exposures, bkg_rate, bkg_err


class SimpleLightcurve(GappyLightcurve):
    """CSV with columns: time, rate, error[, exposure[, bkg_rate, bkg_err]].

    Time columns named mjd/jd/day are interpreted as days and converted to
    seconds (reference simplelightcurve.py:38-42).  Parsing goes through
    the native C table parser (io/_fastio) when the file starts with a
    header line; np.genfromtxt otherwise.
    """

    def __init__(self, input_file, skip_header: int = 0, delimiter=None):
        names = columns = None
        # the native parser collapses consecutive delimiters (an empty
        # CSV field would silently drop the row where genfromtxt yields
        # NaN), so an explicit delimiter always takes the numpy path
        if skip_header == 0 and delimiter is None:
            try:
                from mind_the_gaps_tpu_torch.io import load_columns

                cols = load_columns(input_file)
                if len(cols) >= 3 and not next(iter(cols)).startswith("col"):
                    names = list(cols)
                    columns = [cols[n] for n in names]
            except (OSError, ValueError, IndexError):
                pass  # the genfromtxt path below reads it
        if columns is None:
            data = np.genfromtxt(
                input_file, names=True, skip_header=skip_header, delimiter=delimiter
            )
            names = data.dtype.names
            columns = [data[n] for n in names]
        super().__init__(*_simple_fields(names, columns))


def load_lightcurve_directory(paths, workers: int = 8):
    """Bulk-load SimpleLightcurve-format files: C parse + thread pool
    (the native replacement for looping np.genfromtxt over the
    per-lightcurve .dat files of the reference's script pipeline,
    docs/workflow.md:43-92).  Returns a list of GappyLightcurve."""
    from mind_the_gaps_tpu_torch.io import load_directory
    from mind_the_gaps_tpu_torch.io.fastio import _header_names

    paths = list(paths)
    tables = load_directory(paths, workers=workers)
    out = []
    for path, arr in zip(paths, tables):
        names = _header_names(path)
        if names is None or len(names) != arr.shape[1]:
            names = [f"col{i}" for i in range(arr.shape[1])]
        out.append(GappyLightcurve(*_simple_fields(names, [arr[:, i] for i in range(arr.shape[1])])))
    return out


class SwiftLightcurve(GappyLightcurve):
    """Swift-XRT QDP products (PCCURVE.qdp), with SNR/Sigma/Cts filtering
    and correction-factor handling (reference swiftlightcurve.py:10-108)."""

    def __init__(self, swift_xrt_file="PCCURVE.qdp", minSNR=0, minSigma=0, minCts=0):
        try:
            data = self._read_pccurve(swift_xrt_file, minSNR=minSNR, minSigma=minSigma, minCts=minCts)
        except ValueError:
            data = self._read_simple_pccurve(swift_xrt_file, minSigma=minSigma)

        names = data.dtype.names
        time_column = names[0]
        rate_column = names[3]
        bkg_rate = names[7]
        bkg_rate_err = names[8]
        corr_factor_column = names[9]
        exposure_column = names[12]

        time = np.asarray(data[time_column], dtype=float)
        if time_column == "MJD":
            time = time * _DAY_S
        y = data[rate_column]
        yerr = (-data["%sneg" % rate_column] + data["%spos" % rate_column]) / 2
        corr_factor = data[corr_factor_column]
        # exposure is live-time corrected; background rescaled so that
        # bkg * (exposure / corrfactor) recovers the true bkg contribution
        exposures = data[exposure_column] / corr_factor
        super().__init__(
            time,
            y,
            yerr,
            exposures,
            data[bkg_rate] * corr_factor,
            data[bkg_rate_err] * corr_factor,
        )

    @staticmethod
    def _read_pccurve(file, minExposure=0, minSigma=0, minSNR=0, minCts=0):
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

    @staticmethod
    def _read_simple_pccurve(file, minExposure=0, minSigma=0):
        data = np.genfromtxt(
            file, names=True, delimiter="\t", comments="!",
            dtype=("f8, f8, f8, f8, f8, f8"), deletechars="~", usecols=(0, 1, 2, 3, 4, 5),
        )
        return data[
            ((data["T_+ve"] - data["T_-ve"]) > minExposure) & (data["Sigma"] > minSigma)
        ]


class FermiLightcurve(GappyLightcurve):
    """CSV with asymmetric errors: time, rate, rate_err_neg, rate_err_pos
    (reference fermilightcurve.py:11-46); errors are averaged."""

    def __init__(self, input_file):
        data = np.genfromtxt(input_file, names=True, delimiter=",")
        names = data.dtype.names
        time_column, rate_column = names[0], names[1]
        time = np.asarray(data[time_column], dtype=float)
        if "mjd" in time_column.lower() or "day" in time_column.lower():
            time = time * _DAY_S
        y = data[rate_column]
        yerr = (
            np.abs(data["%s_err_neg" % rate_column]) + data["%s_err_pos" % rate_column]
        ) / 2
        super().__init__(time, y, yerr)
