from . import linalg
from .linalg import (
    add_jitter,
    chol_solve,
    cholesky_with_flag,
    diag_gaussian_logpdf,
    logdet_from_chol,
    mvn_logpdf_chol,
    safe_cholesky,
    tri_solve,
)
