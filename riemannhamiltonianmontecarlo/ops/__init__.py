"""Batched numerical ops: chain-vectorized linalg (with a Pallas GPU kernel), samplers."""

from riemannhamiltonianmontecarlo.ops.gig import sample_gig_half
from riemannhamiltonianmontecarlo.ops.truncnorm import truncated_normal_onesided
from riemannhamiltonianmontecarlo.ops.linalg import (
    cho_solve,
    cholesky,
    inv_psd,
    inv_psd_from_chol,
    logdet_from_chol,
    mvn_sample,
    solve_lower_triangular,
    solve_psd,
    solve_upper_from_lower,
)

__all__ = [
    "cholesky",
    "cho_solve",
    "solve_lower_triangular",
    "solve_upper_from_lower",
    "solve_psd",
    "inv_psd",
    "inv_psd_from_chol",
    "logdet_from_chol",
    "mvn_sample",
    "sample_gig_half",
    "truncated_normal_onesided",
]
