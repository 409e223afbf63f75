"""Normal-Wishart conditional sampling for the BPMF hyper-parameters.

Given the current latent matrix X ([n, K] rows = items of one side), the
conditional posterior of (mu, Lambda) is Normal-Wishart with updated
parameters (Salakhutdinov & Mnih 2008, eq. 14):

    beta* = beta0 + n              nu* = nu0 + n
    mu*   = (beta0 mu0 + n xbar) / (beta0 + n)
    W*^-1 = W0^-1 + n S + (beta0 n / (beta0 + n)) (mu0 - xbar)(mu0 - xbar)^T

with xbar the sample mean and S the (biased) sample covariance. Lambda ~
Wishart(W*, nu*) is drawn with the Bartlett decomposition, then
mu ~ N(mu*, (beta* Lambda)^-1). Keys are split exactly as in
``repro.core.hyper``, so both packages draw the same normals.

``X.T @ X`` is a plain float32 matrix product; the engine keeps
``torch.backends.cuda.matmul.allow_tf32`` off so it stays full float32 on
the GPU. The inverses and Cholesky factors are the ``_ex`` forms, which do
not read their error status back to the host: a singular or indefinite
matrix gives NaN or garbage in the draw, as JAX's give NaN, instead of
raising, and the sweep's metrics row flags a Wishart draw that is not
finite (``hyper_ok``).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.types import HyperParams, NormalWishartPrior


def _sample_wishart(key: torch.Tensor, scale_chol: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Sample from Wishart(scale, df) given chol(scale) via Bartlett.

    Lambda = L A A^T L^T with L = chol(scale), A lower triangular,
    A_ii ~ sqrt(chi2(df - i)), A_ij ~ N(0, 1) for i > j.
    """
    K = scale_chol.shape[-1]
    kn, kc = prng.split(key)
    # chi2(k) = 2 * Gamma(k/2); df - arange(K) > 0 because df >= nu0 + n >= K
    dfs = df - torch.arange(K, dtype=scale_chol.dtype, device=scale_chol.device)
    chi2 = 2.0 * prng.gamma(kc, dfs / 2.0)
    diag = torch.sqrt(chi2)
    normals = prng.normal(kn, (K, K))
    A = torch.tril(normals, -1) + torch.diag(diag)
    LA = scale_chol @ A
    return LA @ LA.T


def hyper_sufficient_stats(
    X: torch.Tensor, weights: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, sum_x, sum_xxT) of the rows of X, the statistics a ring shard contributes.

    ``weights`` masks rows (1 = real item, 0 = a shard's padding slot), so a
    shard can pass its whole ``[cap, K]`` block without biasing the draw.
    """
    if weights is None:
        # filled on the device: no host copy inside a captured sweep
        n = X.new_full((), float(X.shape[0]))
        return n, X.sum(dim=0), X.T @ X
    w = weights.to(X.dtype)
    Xw = X * w[:, None]
    return w.sum(), Xw.sum(dim=0), Xw.T @ X


def sample_hyper_from_stats(
    key: torch.Tensor,
    n: torch.Tensor,
    sum_x: torch.Tensor,
    sum_xxT: torch.Tensor,
    prior: NormalWishartPrior,
) -> HyperParams:
    """Sample (mu, Lambda) from the NW conditional given sufficient stats."""
    K = sum_x.shape[-1]
    eye = torch.eye(K, dtype=sum_x.dtype, device=sum_x.device)
    xbar = sum_x / n
    S = sum_xxT / n - torch.outer(xbar, xbar)
    S = 0.5 * (S + S.T)

    beta_star = prior.beta0 + n
    nu_star = prior.nu0 + n
    mu_star = (prior.beta0 * prior.mu0 + n * xbar) / beta_star
    dm = prior.mu0 - xbar
    W0_inv = torch.linalg.inv_ex(prior.W0)[0]
    Wstar_inv = W0_inv + n * S + (prior.beta0 * n / beta_star) * torch.outer(dm, dm)
    Wstar_inv = 0.5 * (Wstar_inv + Wstar_inv.T)
    Wstar = torch.linalg.inv_ex(Wstar_inv)[0]
    Wstar = 0.5 * (Wstar + Wstar.T)
    scale_chol = torch.linalg.cholesky_ex(Wstar + 1e-10 * eye)[0]

    k_lam, k_mu = prng.split(key)
    Lam = _sample_wishart(k_lam, scale_chol, nu_star)
    Lam = 0.5 * (Lam + Lam.T)

    # mu ~ N(mu*, (beta* Lam)^-1): x = mu* + chol(Lam)^-T z / sqrt(beta*)
    L = torch.linalg.cholesky_ex(Lam + 1e-10 * eye)[0]
    z = prng.normal(k_mu, (K,))
    step = torch.linalg.solve_triangular(L.T, z[:, None], upper=True)[:, 0]
    mu = mu_star + step / torch.sqrt(beta_star)
    return HyperParams(mu=mu, Lam=Lam)


def sample_hyper(key: torch.Tensor, X: torch.Tensor, prior: NormalWishartPrior) -> HyperParams:
    """Sample (mu, Lambda) from the NW conditional given latent rows X."""
    n, sx, sxx = hyper_sufficient_stats(X)
    return sample_hyper_from_stats(key, n, sx, sxx, prior)


def hyper_ok(*hypers: HyperParams) -> torch.Tensor:
    """0-dim bool on the device: every ``Lam`` is finite.

    False when a gamma entry found no accepted proposal (``prng.gamma``
    returns NaN there) or a factorization failed; the sweeps put it in
    their metrics rows so the block's one read carries it.
    """
    return torch.stack([torch.isfinite(h.Lam).all() for h in hypers]).all()
