"""Closed-form small-matrix linear algebra (port of ``ur_mvo_tpu.ops.linalg``).

The analytic routines are ported as they are, not swapped for
``torch.linalg``: the RANSAC gates were tuned against them. Everything
broadcasts over leading batch dimensions. Products are written as
elementwise multiply-and-sum (:func:`mm`), so they run in true float32 on
the card whatever the TF32 settings are: the JAX package pins these to
``Precision.HIGHEST``.
"""

from __future__ import annotations

import math

import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, k) x (..., k, n) in true float32 (no TF32)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def assert_true_float32_matmul() -> None:
    """Geometry never runs TF32: a function that calls a real ``matmul``
    on float32 checks the process setting instead of changing it."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r}; the geometry needs 'highest' "
            "(torch.set_float32_matmul_precision('highest'))"
        )


def det3(A: torch.Tensor) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def eigh3x3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Analytic eigendecomposition of symmetric (..., 3, 3) matrices.

    Returns (eigenvalues ascending (..., 3), eigenvectors (..., 3, 3) with
    columns as eigenvectors). Trigonometric (Cardano) eigenvalues +
    cross-product eigenvectors.
    """
    A = 0.5 * (A + A.transpose(-1, -2))
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2])[..., None, None] / 3.0
    B = A - q * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = det3(B) / torch.clamp(2.0 * p**3, min=1e-30)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    q0 = q[..., 0, 0]
    e1 = q0 + 2.0 * p * torch.cos(phi)
    e3 = q0 + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q0 - e1 - e3
    evals = torch.stack([e3, e2, e1], dim=-1)  # ascending

    def eigvec(lam):
        # (A - lam I) has rank 2; its row cross products span the kernel.
        M = A - lam[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        cands = torch.stack([cross(r0, r1), cross(r1, r2), cross(r2, r0)], dim=-2)
        norms = torch.sum(cands * cands, dim=-1)
        best = torch.argmax(norms, dim=-1)
        v = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
        n = _norm(v)
        # Degenerate (repeated eigenvalue): fall back to a fixed axis.
        fallback = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype, device=A.device).expand(v.shape)
        return torch.where(n > 1e-20, v / torch.clamp(n, min=1e-20), fallback)

    v0 = eigvec(evals[..., 0])
    v2 = eigvec(evals[..., 2])
    # middle eigenvector: orthogonal complement (exact for symmetric A)
    v1 = cross(v2, v0)
    v1 = v1 / torch.clamp(_norm(v1), min=1e-20)
    V = torch.stack([v0, v1, v2], dim=-1)
    return evals, V


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def tril_inverse_small(L: torch.Tensor) -> torch.Tensor:
    """Unrolled inverse of lower-triangular (..., n, n) (forward subst)."""
    n = L.shape[-1]
    X = [[None] * n for _ in range(n)]
    for j in range(n):
        X[j][j] = 1.0 / L[..., j, j]
        for i in range(j + 1, n):
            s = L[..., i, j] * X[j][j]
            for k in range(j + 1, i):
                s = s + L[..., i, k] * X[k][j]
            X[i][j] = -s / L[..., i, i]
    zero = torch.zeros_like(L[..., 0, 0])
    rows = [torch.stack([X[i][j] if j <= i else zero for j in range(n)], dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2)


def qr_r_small(A: torch.Tensor) -> torch.Tensor:
    """Unrolled Householder QR of (..., m, n), m >= n: returns the upper
    triangular factor R (..., n, n) with A = Q R."""
    m, n = A.shape[-2], A.shape[-1]
    A = A.clone()
    for j in range(n):
        x = A[..., j:, j]  # (..., m-j)
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        x0 = x[..., :1]
        # sign chosen to avoid cancellation; alpha = -sign(x0) * |x|
        sign = torch.where(x0 >= 0, 1.0, -1.0)
        alpha = -sign * norm
        v = x.clone()
        v[..., :1] = v[..., :1] - alpha
        vtv = torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-30)
        sub = A[..., j:, j:]  # (..., m-j, n-j)
        vt_sub = torch.sum(v[..., :, None] * sub, dim=-2)  # (..., n-j)
        sub = sub - (2.0 / vtv)[..., :, None] * v[..., :, None] * vt_sub[..., None, :]
        # column j is exactly (alpha, 0, ..., 0) after the reflection
        sub[..., :, 0] = 0.0
        sub[..., 0, 0] = alpha[..., 0]
        A[..., j:, j:] = sub
    return torch.triu(A[..., :n, :])


def smallest_singular_vector(A: torch.Tensor, iterations: int = 8) -> torch.Tensor:
    """Right-singular vector of the smallest singular value of ``A``
    (..., m, n): inverse iteration with the triangular factor of an
    unrolled Householder QR of ``A`` itself (never forming A^T A), with
    near-zero diagonal entries clamped relative to the largest."""
    n = A.shape[-1]
    m = A.shape[-2]
    scale = torch.sqrt(torch.clamp(torch.mean(A * A, dim=(-2, -1), keepdim=True), min=1e-30))
    A = A / scale
    if m < n:
        # underdetermined minimal systems (the 8x9 eight-point matrix):
        # zero rows leave A^T A unchanged and give the QR factor exact
        # zero diagonal entries for the null space
        pad = torch.zeros(A.shape[:-2] + (n - m, n), dtype=A.dtype, device=A.device)
        A = torch.cat([A, pad], dim=-2)
    R = qr_r_small(A)
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    dmax = torch.clamp(torch.max(torch.abs(diag), dim=-1, keepdim=True).values, min=1e-30)
    sgn = torch.where(diag >= 0, 1.0, -1.0)
    dsafe = torch.where(torch.abs(diag) < 1e-7 * dmax, 1e-7 * dmax * sgn, diag)
    ii = torch.arange(n, device=A.device)
    R[..., ii, ii] = dsafe
    # explicit triangular inverse (R upper): R^-1 = (tril_inv(R^T))^T
    Rinv = tril_inverse_small(R.transpose(-1, -2)).transpose(-1, -2)
    v = torch.ones(A.shape[:-2] + (n,), dtype=A.dtype, device=A.device) / math.sqrt(n)
    for _ in range(iterations):
        # v <- R^-1 (R^-T v), normalized after each triangular application
        w = torch.sum(Rinv * v[..., :, None], dim=-2)
        w = w / torch.clamp(_norm(w), min=1e-30)
        v = torch.sum(Rinv * w[..., None, :], dim=-1)
        v = v / torch.clamp(_norm(v), min=1e-30)
    return v


def cholesky_small(M: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky of SPD (..., n, n) for tiny fixed n (<= ~16).
    Returns lower-triangular L with M = L L^T; pivots are clamped at
    1e-10 so the factor stays finite on a semi-definite input."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-10))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            t = M[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
    zero = torch.zeros_like(M[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2)


def spd_inverse_small(M: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of SPD (..., n, n) via the unrolled Cholesky:
    M^{-1} = L^{-T} L^{-1}."""
    Linv = tril_inverse_small(cholesky_small(M))
    return mm(Linv.transpose(-1, -2), Linv)


def nearest_rotation(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Polar decomposition: the rotation closest to (..., 3, 3) ``M`` with
    det +1, plus the mean scale. R = M (M^T M)^{-1/2} from the analytic
    3x3 eigensolver, the smallest-eigenvalue axis sign-fixed for
    properness, then three Higham polish steps R <- (R + R^-T) / 2 (the
    Cardano eigenvectors lose orthogonality when M^T M is nearly a
    multiple of the identity; the polish recovers the polar factor)."""
    MtM = mm(M.transpose(-1, -2), M)
    evals, V = eigh3x3(MtM)
    s = torch.sqrt(torch.clamp(evals, min=1e-30))  # singular values ascending
    sign = torch.where(det3(M) < 0, -1.0, 1.0).to(M.dtype)
    d = torch.stack([sign / s[..., 0], 1.0 / s[..., 1], 1.0 / s[..., 2]], dim=-1)
    inv_sqrt = mm(V * d[..., None, :], V.transpose(-1, -2))
    R = mm(M, inv_sqrt)
    for _ in range(3):
        R = 0.5 * (R + inv3x3(R).transpose(-1, -2))
    scale = torch.mean(s, dim=-1) * sign
    return R, scale
