"""Unrolled dense linear algebra for tiny static-size SPD systems.

Torch twin of mbb_emcee_tpu/ops/smalllinalg.py. The MAP/Laplace path
(mapfit.py) solves (H + lambda I) d = -g for a <= 5 x 5 Hessian per
optimizer start, batched over sources and starts. These helpers unroll the
Cholesky factorization and the triangular substitutions over the static
trailing dimension into elementwise arithmetic on the leading batch, so the
whole batch is a handful of elementwise launches and no LAPACK call.

All functions take matrices with arbitrary leading batch dimensions and a
static trailing (n, n), n small (intended n <= 8). Indefinite inputs are
handled by a pivot floor inside the factorization (pivots floored at a tiny
positive value times the mean |diagonal|), the regularization the
damped-Newton caller wants instead of NaNs.
"""

from __future__ import annotations

import torch


def cholesky_small(A, floor=1e-30):
    """Lower-triangular L with L L^T = A (SPD), unrolled over the static
    trailing (n, n). Pivots are floored at `floor` * (mean |diagonal|) so
    an indefinite A yields a finite (regularized) factor, not NaNs."""
    n = A.shape[-1]
    scale = torch.clamp(
        torch.mean(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1),
        min=1e-30)
    rows = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                rows[i][j] = torch.sqrt(torch.maximum(s, floor * scale))
            else:
                rows[i][j] = s / rows[j][j]
    zero = torch.zeros_like(A[..., 0, 0])
    cols = [torch.stack([rows[i][j] if i >= j else zero for i in range(n)],
                        dim=-1) for j in range(n)]
    return torch.stack(cols, dim=-1)


def solve_tri_lower(L, b):
    """x with L x = b (L lower-triangular), unrolled. b: (..., n)."""
    n = L.shape[-1]
    xs = []
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * xs[k]
        xs.append(s / L[..., i, i])
    return torch.stack(xs, dim=-1)


def solve_tri_upper_t(L, y):
    """x with L^T x = y (the factor of cholesky_small), unrolled."""
    n = L.shape[-1]
    xs = [None] * n
    for i in reversed(range(n)):
        s = y[..., i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * xs[k]
        xs[i] = s / L[..., i, i]
    return torch.stack(xs, dim=-1)


def spd_solve_small(A, b, floor=1e-30):
    """x with A x = b for tiny SPD A via the unrolled Cholesky."""
    L = cholesky_small(A, floor)
    return solve_tri_upper_t(L, solve_tri_lower(L, b))


def spd_inverse_small(A, floor=1e-30):
    """inv(A) for tiny SPD A: Cholesky solves against the identity
    columns, symmetrized."""
    n = A.shape[-1]
    L = cholesky_small(A, floor)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    cols = [solve_tri_upper_t(L, solve_tri_lower(
        L, eye[j].expand(A.shape[:-2] + (n,)))) for j in range(n)]
    inv = torch.stack(cols, dim=-1)
    return 0.5 * (inv + inv.transpose(-1, -2))
