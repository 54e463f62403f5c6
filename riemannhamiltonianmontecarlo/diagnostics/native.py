"""ctypes binding for the native ESS engine (native/fastess.cpp).

Falls back to the NumPy implementation when the shared library is not
built.  Build with ``make -C native``.  The native path implements the
alias-free ("exact") ACF variant; reference-mode parity runs use the
NumPy path (see diagnostics/ess.py docstring).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libfastess.so"
_lib = None


def _load(build_if_missing: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and build_if_missing:
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True
            )
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.geyer_ess_batch.restype = ctypes.c_int
    lib.geyer_ess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def ess_geyer_native(
    samples: np.ndarray, max_lag: int | None = None, num_threads: int = 0
) -> np.ndarray:
    """Geyer ESS per series via the native engine.

    samples: (N, P) or (C, N, P) -> (P,) per-series / summed over chains,
    matching ``diagnostics.ess_geyer`` / ``ess_multichain`` with
    nfft_mode="exact".
    """
    lib = _load()
    x = np.asarray(samples, dtype=np.float64)
    if lib is None:
        from riemannhamiltonianmontecarlo.diagnostics.ess import (
            ess_geyer,
            ess_multichain,
        )

        if x.ndim == 3:
            return ess_multichain(x, max_lag, nfft_mode="exact")
        return ess_geyer(x, max_lag, nfft_mode="exact")

    multichain = x.ndim == 3
    if multichain:
        c, n, p = x.shape
        series = np.ascontiguousarray(np.moveaxis(x, 1, 2).reshape(c * p, n))
    else:
        n, p = x.shape
        series = np.ascontiguousarray(x.T)
    if max_lag is None:
        max_lag = n - 1
    out = np.empty(series.shape[0], dtype=np.float64)
    rc = lib.geyer_ess_batch(
        series.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        series.shape[0],
        n,
        max_lag,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"geyer_ess_batch failed with code {rc}")
    if multichain:
        return out.reshape(c, p).sum(axis=0)
    return out
