"""Effective sample size: Geyer initial-monotone-sequence estimator.

Semantics-compatible re-derivation of the reference estimator
(``code/tools.py:21-74`` / MATLAB ``Results/CalculateESS.m``), because the
north-star metric (ESS/s, BASELINE.md) is *defined* by this estimator and
speedup claims must be apples-to-apples:

* autocorrelation by Wiener-Khinchin FFT of the demeaned series
  (``code/tools.py:21-30``);
* pair sums ``Gamma_j = rho_{2j} + rho_{2j+1}`` (``tools.py:49-50``);
* running-min monotonization (``tools.py:54-60``);
* ``MonoEst = -rho_0 + 2 * sum of the positive (monotone) Gamma prefix``
  clipped at >= 1 (``tools.py:62-71``);  ESS = N / MonoEst.

Monotonization makes the Gamma sequence non-increasing, so "indices with
Gamma > 0" form a prefix and the reference's ``len(PosGammas)``-prefix sum
equals the sum of the strictly positive entries -- which is how it is
vectorized here (no Python loops over parameters).

``nfft_mode``:
  * ``"reference"`` -- nFFT = nextpow2(N) + 1, reproducing the reference
    Python port verbatim (``code/tools.py:23``).  NOTE: this length is too
    short for exact linear autocorrelation (needs >= 2N - 1), so high lags
    alias; the MATLAB original uses ``2^(nextpow2(N) + 1)``.  Kept as the
    default for strict parity with the re-timed reference denominator.
  * ``"exact"`` -- nFFT = 2 * nextpow2(N): alias-free linear ACF (matches
    the MATLAB semantics).

Diagnostics run host-side in NumPy (float64): they are post-processing,
not hot-path, and the reference pipeline is float64.
"""

from __future__ import annotations

import jax
import numpy as np


def nextpow2(i: int) -> int:
    n = 1
    while n < i:
        n *= 2
    return n


def autocorrelation(samples: np.ndarray, max_lag: int, nfft_mode: str = "reference") -> np.ndarray:
    """Column-wise ACF up to ``max_lag`` inclusive.

    samples: (N, P) -> (max_lag + 1, P), normalized so lag 0 is 1.
    """
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    if nfft_mode == "reference":
        nfft = nextpow2(n) + 1
    elif nfft_mode == "exact":
        nfft = 2 * nextpow2(n)
    else:
        raise ValueError(f"nfft_mode must be 'reference' or 'exact', got {nfft_mode!r}")
    f = np.fft.fft(x - x.mean(axis=0), n=nfft, axis=0)
    acf = np.fft.ifft(f * np.conj(f), axis=0).real[: max_lag + 1]
    return acf / acf[0]


def ess_geyer(
    samples: np.ndarray, max_lag: int | None = None, nfft_mode: str = "reference"
) -> np.ndarray:
    """Geyer initial-monotone ESS per parameter.  samples: (N, P) -> (P,)."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    if max_lag is None:
        max_lag = n - 1
    acs = autocorrelation(x, max_lag, nfft_mode)  # (max_lag+1, P)
    half = (max_lag + 1) // 2
    gamma = acs[0 : 2 * half : 2] + acs[1 : 2 * half : 2]  # (half, P)
    gamma = np.minimum.accumulate(gamma, axis=0)  # initial monotone sequence
    mono = -acs[0] + 2.0 * np.sum(np.where(gamma > 0.0, gamma, 0.0), axis=0)
    mono = np.maximum(mono, 1.0)
    return n / mono


def ess_geyer_device(samples, max_lag: int | None = None, max_bytes: int = 1 << 29):
    """Device-side Geyer ESS (exact/alias-free mode), pure jnp.

    samples: (N, P) or (C, N, P) jax array -> (P,) [summed over chains].
    Uses a power-of-2 FFT; equivalent to
    ``ess_geyer(..., nfft_mode="exact")`` up to f32 precision.  Useful for
    in-loop monitoring without host transfers.

    The parameter axis is processed in chunks so the complex FFT scratch
    stays under ``max_bytes`` (the full LGC/StochVol latent fields would
    otherwise need multi-GB buffers: C x 2*nextpow2(N) x P complex64).

    ``samples`` may also be a host ``np.ndarray`` (e.g. kept samples
    streamed off-device per segment because the full trajectory does not
    fit HBM -- StochVol at 64+ chains keeps C x 20000 x 2003 f32).  In
    that case demeaning and chunk slicing happen host-side and only one
    (C, N, chunk) slab lives on device at a time.
    """
    import jax.numpy as jnp

    on_host = isinstance(samples, np.ndarray)
    x = samples
    multichain = x.ndim == 3
    if not multichain:
        x = x[None]
    c, n, p = x.shape
    if max_lag is None:
        max_lag = n - 1
    nfft = 2 * nextpow2(n)

    def chunk_ess(xc_chunk):
        xc_chunk = jnp.asarray(xc_chunk)
        f = jnp.fft.fft(xc_chunk, n=nfft, axis=1)
        acf = jnp.fft.ifft(f * jnp.conj(f), axis=1).real[:, : max_lag + 1]
        acf = acf / jnp.maximum(acf[:, :1], 1e-30)
        half = (max_lag + 1) // 2
        gamma = acf[:, 0 : 2 * half : 2] + acf[:, 1 : 2 * half : 2]
        gamma = jax.lax.associative_scan(jnp.minimum, gamma, axis=1)
        mono = -acf[:, 0] + 2.0 * jnp.sum(jnp.where(gamma > 0.0, gamma, 0.0), axis=1)
        return n / jnp.maximum(mono, 1.0)  # (C, chunk)

    if on_host:
        x = np.asarray(x, np.float32)
        xc = x - x.mean(axis=1, keepdims=True)
    else:
        xc = x - jnp.mean(x, axis=1, keepdims=True)
    chunk = max(int(max_bytes // (8 * c * nfft)), 1)
    if chunk >= p and not on_host:
        ess = chunk_ess(xc)
    else:
        parts = [
            np.asarray(chunk_ess(xc[:, :, lo : lo + chunk]))
            for lo in range(0, p, chunk)
        ]
        ess = jnp.asarray(np.concatenate(parts, axis=1))
    return jnp.sum(ess, axis=0) if multichain else ess[0]


def _parts_chunk_ess(xc, n: int, nfft: int, max_lag: int):
    """Geyer ESS of one coordinate chunk, summed over chains.

    xc: (C, N, chunk) -> (chunk,).  Module-level jit so the compiled
    program is reused across chunks, seeds, and callers.
    """
    import jax.numpy as jnp

    xc = xc - jnp.mean(xc, axis=1, keepdims=True)
    f = jnp.fft.fft(xc, n=nfft, axis=1)
    acf = jnp.fft.ifft(f * jnp.conj(f), axis=1).real[:, : max_lag + 1]
    acf = acf / jnp.maximum(acf[:, :1], 1e-30)
    half = (max_lag + 1) // 2
    gamma = acf[:, 0 : 2 * half : 2] + acf[:, 1 : 2 * half : 2]
    gamma = jax.lax.associative_scan(jnp.minimum, gamma, axis=1)
    mono = -acf[:, 0] + 2.0 * jnp.sum(jnp.where(gamma > 0.0, gamma, 0.0), axis=1)
    return jnp.sum(n / jnp.maximum(mono, 1.0), axis=0)


_parts_chunk_ess_jit = jax.jit(
    _parts_chunk_ess, static_argnames=("n", "nfft", "max_lag")
)


def ess_geyer_device_parts(parts, max_lag: int | None = None,
                           max_bytes: int = 1 << 29) -> np.ndarray:
    """Chain-summed Geyer ESS of a trajectory stored as device segments.

    ``parts``: list of (C, N_i, P) device arrays -- the kept samples as
    produced segment-by-segment.  The full (C, sum N_i, P) tensor is never
    materialized: per coordinate chunk the segments are sliced,
    concatenated, FFT'd and freed, so peak extra HBM is one
    (C, N, chunk) buffer plus the complex FFT scratch (< ``max_bytes``).
    Returns the (P,) chain-summed ESS as a host array.
    """
    import jax.numpy as jnp

    c, _, p = parts[0].shape
    n = int(sum(pt.shape[1] for pt in parts))
    if max_lag is None:
        max_lag = n - 1
    nfft = 2 * nextpow2(n)
    chunk = max(int(max_bytes // (8 * c * nfft)), 1)
    outs = []
    for lo in range(0, p, chunk):
        xc = jnp.concatenate([pt[:, :, lo : lo + chunk] for pt in parts], axis=1)
        outs.append(np.asarray(
            _parts_chunk_ess_jit(xc, n=n, nfft=nfft, max_lag=max_lag)))
        del xc
    return np.concatenate(outs)


def ess_multichain(
    samples: np.ndarray, max_lag: int | None = None, nfft_mode: str = "reference"
) -> np.ndarray:
    """Total ESS over independent chains: sum of per-chain Geyer ESS.

    samples: (C, N, P) -> (P,).  For independent chains, effective samples
    add; this is the quantity the ESS/s benchmark maximizes.
    """
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 2:
        return ess_geyer(x, max_lag, nfft_mode)
    c, n, p = x.shape
    # Batch the FFT across chains and parameters in one call: (N, C*P).
    flat = np.moveaxis(x, 1, 0).reshape(n, c * p)
    per = ess_geyer(flat, max_lag, nfft_mode).reshape(c, p)
    return per.sum(axis=0)
