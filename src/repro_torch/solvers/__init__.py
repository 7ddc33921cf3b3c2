"""Inverse-problem solvers on :class:`repro_torch.filters.GraphFilter`.

Mirrors ``repro/solvers``. The paper's Sec. V-C denoising, inverse
filtering (arXiv:2003.11152) and graph Wiener reconstruction
(arXiv:2205.04019) are iterations whose every step is a Chebyshev
recurrence, so they run on every registered backend; on ``bsr`` their
filter applies are the CUDA kernels. ``cheb_inverse`` and
``cheb_preconditioner`` (arXiv:2504.14341) are ported for single-shift
filters.

Quickstart::

    from repro_torch.solvers import LassoProblem, fista

    problem = LassoProblem(filt=wavelet_filter, y=noisy, mu=2.0)
    res = fista(problem, n_iters=40, tol=1e-6, backend="bsr")
    denoised, coeffs = res.x, res.aux
"""

from repro_torch.solvers.api import GramProblem, LassoProblem, SolveResult
from repro_torch.solvers.inverse import (
    ChebyshevPreconditioner,
    cheb_inverse,
    cheb_preconditioner,
)
from repro_torch.solvers.iterative import (
    conjugate_gradient,
    fista,
    ista,
    lasso_panel_program,
    solve,
    wiener,
)
from repro_torch.solvers.loops import iterate

__all__ = [
    "ChebyshevPreconditioner",
    "GramProblem",
    "LassoProblem",
    "SolveResult",
    "cheb_inverse",
    "cheb_preconditioner",
    "conjugate_gradient",
    "fista",
    "ista",
    "iterate",
    "lasso_panel_program",
    "solve",
    "wiener",
]
