"""Moment-factored line-search polynomials.

Port of the JAX package's `core/step_factored.py`.  Each per-pair
quantity of cvo::compute_step_size (cvo.cpp:249-289) is a product of
affine functions of the fixed point x_i, so B, C, D, E = sum_ij A_ij
P_k(x_i) with P_k polynomials of degree <= 4 in x_i whose coefficients
depend only on j.  `Poly` multiplies the affine forms symbolically, with
[M]-vector coefficients; the result is contracted against the moment
matrix in core/moments.py (kernel backend) or against A @ coefficients
and Phi(x) (dense backend, `step_coefficients_factored`).
"""

from __future__ import annotations

import itertools

import torch

from cvo_rgbd_torch.se3 import skew

# monomial basis: exponent triples (e0, e1, e2) with sum <= 4
MONOMIALS = [
    e
    for total in range(5)
    for e in sorted(
        {
            tuple(m)
            for m in itertools.product(range(5), repeat=3)
            if sum(m) == total
        }
    )
]
M_INDEX = {e: i for i, e in enumerate(MONOMIALS)}
NUM_MONO = len(MONOMIALS)  # 35


class Poly:
    """Polynomial in (x0, x1, x2), coefficients are [M]-vectors."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms or {})  # {exponent_triple: [M] tensor}

    @staticmethod
    def affine(a, b):
        """a + b . x with a [M], b [M,3]."""
        return Poly({
            (0, 0, 0): a,
            (1, 0, 0): b[:, 0],
            (0, 1, 0): b[:, 1],
            (0, 0, 1): b[:, 2],
        })

    def __add__(self, other):
        out = dict(self.terms)
        for e, c in other.terms.items():
            out[e] = out[e] + c if e in out else c
        return Poly(out)

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return Poly({e: c * other for e, c in self.terms.items()})
        out = {}
        for e1, c1 in self.terms.items():
            for e2, c2 in other.terms.items():
                e = (e1[0] + e2[0], e1[1] + e2[1], e1[2] + e2[2])
                if sum(e) > 4:
                    raise ValueError("degree > 4")
                c = c1 * c2
                out[e] = out[e] + c if e in out else c
        return Poly(out)

    __rmul__ = __mul__


def monomial_features(x: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] -> [..., N, 35] monomial features.  Powers are
    explicit products in the JAX order (x^3 = x*(x*x), x^4 = (x*x)*(x*x))."""
    def pows(v):
        v2 = v * v
        return [torch.ones_like(v), v, v2, v * v2, v2 * v2]

    p0, p1, p2 = pows(x[..., 0]), pows(x[..., 1]), pows(x[..., 2])
    return torch.stack(
        [p0[e[0]] * p1[e[1]] * p2[e[2]] for e in MONOMIALS], dim=-1
    )


def affine_forms(y_field, y_pair, omega, v, ell):
    """Per-j affine coefficients (a [M], b [M,3]) of the four line-search
    integrand factors beta/gamma/delta/epsilon (cvo.cpp:262-271), as
    functions of the fixed point x:  factor_ij = a_j + b_j . x_i.

    `y_field`: the moving points the derivative fields xi^k z are built
    from (cvo.cpp:226-238); `y_pair`: the same points shifted by the
    center the x monomials use."""
    w_hat = skew(omega)
    w2 = w_hat @ w_hat
    w3 = w2 @ w_hat
    w4 = w3 @ w_hat

    xiz = torch.linalg.cross(omega.expand_as(y_field), y_field, dim=-1) + v
    xi2z = y_field @ w2.T + (w_hat @ v[..., None])[..., 0]
    xi3z = y_field @ w3.T + (w2 @ v[..., None])[..., 0]
    xi4z = y_field @ w4.T + (w3 @ v[..., None])[..., 0]

    normxiz2 = torch.sum(xiz * xiz, dim=-1)
    xzx2 = -torch.sum(xiz * xi2z, dim=-1)
    eps_const = torch.sum(xi2z * xi2z, dim=-1) + 2.0 * torch.sum(
        xiz * xi3z, dim=-1
    )

    tc = 1.0 / (2.0 * ell * ell)
    b_a = 2.0 * tc * torch.sum(xiz * y_pair, -1)
    b_b = -2.0 * tc * xiz
    g_a = -tc * normxiz2 + 2.0 * tc * torch.sum(xi2z * y_pair, -1)
    g_b = -2.0 * tc * xi2z
    d_a = 2.0 * tc * xzx2 + 2.0 * tc * torch.sum(xi3z * y_pair, -1)
    d_b = -2.0 * tc * xi3z
    e_a = -tc * eps_const + 2.0 * tc * torch.sum(xi4z * y_pair, -1)
    e_b = -2.0 * tc * xi4z
    return (b_a, b_b), (g_a, g_b), (d_a, d_b), (e_a, e_b)


def line_search_polys(y_field, y_pair, omega, v, ell):
    """The four line-search polynomials P_B..P_E (cvo.cpp:249-289) as
    `Poly` objects over the centered fixed-point coordinate."""
    (b_a, b_b), (g_a, g_b), (d_a, d_b), (e_a, e_b) = affine_forms(
        y_field, y_pair, omega, v, ell
    )
    beta = Poly.affine(b_a, b_b)
    gamma = Poly.affine(g_a, g_b)
    delta = Poly.affine(d_a, d_b)
    epsil = Poly.affine(e_a, e_b)
    beta2 = beta * beta
    P_B = beta
    P_C = gamma + 0.5 * beta2
    P_D = delta + beta * gamma + (1.0 / 6.0) * (beta2 * beta)
    P_E = (
        epsil
        + beta * delta
        + 0.5 * (beta2 * gamma)
        + 0.5 * (gamma * gamma)
        + (1.0 / 24.0) * (beta2 * beta2)
    )
    return P_B, P_C, P_D, P_E


def step_coefficients_factored(A, x_pos, y_pos, omega, v, ell):
    """B, C, D, E of the quartic objective from a dense Gram (the dense
    backend's `step_mode="factored"`): the four polynomials' [M, 35]
    coefficients stacked to [M, 140], then one [N,M]x[M,140] product
    contracted with Phi(x).  Both clouds are first centered on the
    A-weighted centroid of x (exact: only x - y enters), which keeps |x|
    at cloud-extent scale and bounds the degree-4 monomial cancellation."""
    row = torch.sum(A, dim=1)
    tot = torch.clamp_min(torch.sum(row), 1e-30)
    centroid = (row @ x_pos) / tot
    x_c = x_pos - centroid
    polys = line_search_polys(y_pos, y_pos - centroid, omega, v, ell)
    zero = torch.zeros_like(y_pos[:, 0])
    C_all = torch.stack(
        [P.terms.get(e, zero) for P in polys for e in MONOMIALS], dim=1
    )
    AC = A @ C_all                       # [N, 140], the only big product
    phi = monomial_features(x_c)
    out = torch.sum(AC.reshape(AC.shape[0], 4, NUM_MONO) * phi[:, None, :],
                    dim=(0, 2))
    return out[0], out[1], out[2], out[3]
