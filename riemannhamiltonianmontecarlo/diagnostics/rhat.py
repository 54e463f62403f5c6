"""Split R-hat and cross-chain summaries.

The reference has no multi-chain diagnostics (it averages 10 serial runs,
``code/main.py:48-54``).  With thousands of parallel chains, potential-
scale-reduction is the natural convergence check, computed across all
chains and hosts.

`split_rhat_device` is pure ``jnp`` so it can run inside a jitted /
shard_map'ed program with chain statistics reduced by ``psum`` across the
mesh (see ``parallel/collectives.py``); `split_rhat` is the host NumPy
version for post-processing.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Gelman-Rubin split-R-hat.  samples: (C, N, P) -> (P,)."""
    x = np.asarray(samples, dtype=np.float64)
    c, n, p = x.shape
    half = n // 2
    halves = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)  # (2C, half, P)
    m, s = halves.shape[0], halves.shape[1]
    chain_mean = halves.mean(axis=1)  # (2C, P)
    chain_var = halves.var(axis=1, ddof=1)  # (2C, P)
    w = chain_var.mean(axis=0)
    b = s * chain_mean.var(axis=0, ddof=1)
    var_plus = (s - 1) / s * w + b / s
    return np.sqrt(var_plus / w)


def split_rhat_device(samples: jnp.ndarray) -> jnp.ndarray:
    """Device-side split-R-hat over local chains.  samples: (C, N, P) -> (P,)."""
    c, n, p = samples.shape
    half = n // 2
    halves = jnp.concatenate([samples[:, :half], samples[:, half : 2 * half]], axis=0)
    s = halves.shape[1]
    chain_mean = halves.mean(axis=1)
    chain_var = halves.var(axis=1, ddof=1)
    w = chain_var.mean(axis=0)
    b = s * chain_mean.var(axis=0, ddof=1)
    var_plus = (s - 1) / s * w + b / s
    return jnp.sqrt(var_plus / w)


def split_rhat_parts(parts) -> np.ndarray:
    """Split-R-hat of a trajectory stored as per-segment device arrays.

    ``parts``: list of (C, N_i, P) device arrays in sample order (the same
    representation ``ess_geyer_device_parts`` consumes -- kept samples too
    large to concatenate on a 16 GB chip).  Accumulates per-half per-chain
    first/second moments on device (each reduction touches one part at a
    time), shifted by each chain's first sample so the f32 sums stay small,
    then finishes the Gelman-Rubin formula in f64 on host.  Returns (P,).
    """
    c, _, p = parts[0].shape
    n = int(sum(pt.shape[1] for pt in parts))
    half = n // 2
    # One shift per COORDINATE, constant across chains: a per-chain shift
    # would distort the between-chain variance B.  Variance-invariant.
    ref = jnp.mean(parts[0][:, :1, :], axis=0, keepdims=True)  # (1, 1, P)
    s = np.zeros((2, c, p), np.float64)
    ss = np.zeros((2, c, p), np.float64)
    cnt = np.zeros(2, np.int64)
    off = 0
    for pt in parts:
        ni = pt.shape[1]
        for h in range(2):
            lo = max(0, h * half - off)
            hi = min(ni, (h + 1) * half - off)
            if hi <= lo:
                continue
            x = pt[:, lo:hi] - ref
            s[h] += np.asarray(jnp.sum(x, axis=1), np.float64)
            ss[h] += np.asarray(jnp.sum(x * x, axis=1), np.float64)
            cnt[h] += hi - lo
        off += ni
    m = s / cnt[:, None, None]  # (2, C, P) per-half chain means (shifted)
    var = (ss - cnt[:, None, None] * m * m) / (cnt[:, None, None] - 1)
    chain_mean = m.reshape(2 * c, p)
    chain_var = var.reshape(2 * c, p)
    w = chain_var.mean(axis=0)
    b = half * chain_mean.var(axis=0, ddof=1)
    var_plus = (half - 1) / half * w + b / half
    return np.sqrt(var_plus / np.maximum(w, 1e-300))
