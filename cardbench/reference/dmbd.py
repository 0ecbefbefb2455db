"""Plain PyTorch reference of one VB-EM sweep of Dynamic Markov Blanket
Discovery (DMBD), the model the benchmark's cells fit.

The model: observables y[t, b, o] (n numbers each) are emitted by one of K
roles, each role a linear map of the latent x_t (H numbers, shared by the
observables of a trajectory) and a bias; each observable's role follows a
Markov chain.  x_t follows a linear dynamical system.  Structural masks
partition x into environment, blanket and internal blocks per object and
restrict the dynamics, the emissions and the role transitions.  Priors and
posteriors: x_{-1} Normal-inverse-Wishart; the dynamics A Matrix-normal with
diagonal Gamma row precisions; the emissions B Matrix-normal-Wishart per
role; the role transitions and initial role Dirichlet.

One sweep (``sweep``): the role E-step (forward-backward over each
observable's chain, given the previous latent posterior), the role M-step
(the two Dirichlets and the emissions), the latent E-step (information
filter and smoother with the role-averaged messages), the ELBO, and the
latent M-step (x_{-1} and A), each step damped by ``lr``.  The smoothers
are sequential loops over time; the pair covariances come from inverting
each (x_{t-1}, x_t) pair's joint precision.  Nothing here imports the
program that the benchmark measures; its results are what the program's
sweeps are judged against.

Tensors carry no singleton axes: x_{-1} (H,), A (H, H + 1) with the bias
column last, B (K, n, H + 1), y (T, batch, O, n).
"""
from __future__ import annotations

import math

import numpy as np
import torch

LOG2PI = math.log(2 * math.pi)


def mT(a):
    return a.transpose(-1, -2)


def sym(a):
    return 0.5 * (a + mT(a))


def inv(a):
    return torch.linalg.inv(sym(a))


def logdet(a):
    return torch.linalg.slogdet(sym(a))[1]


def mvdigamma(x, d):
    return sum(torch.digamma(x - i / 2.0) for i in range(d))


def mvlgamma(x, d):
    return sum(torch.lgamma(x - i / 2.0) for i in range(d))


# ------------------------------------------------------------------ structure
def masks(role_dims, hidden_dims, objects):
    """(A_mask (H, H + 1), X_mask (K, H + 1), role_mask (K, K)) as bool
    arrays.  Blocks are ordered environment, then blanket and internal of
    each object.  The environment drives itself and every blanket; a
    blanket is driven by the environment and by its own object; an
    internal block only by its own object.  A role reads the latent block
    of its own kind and object, and the bias."""
    def labels(dims):
        out = [("s", 0)] * dims[0]
        for i in range(1, objects + 1):
            out += [("b", i)] * dims[1] + [("z", i)] * dims[2]
        return out

    def allowed(r, c):
        if r[0] == "s":
            return c[0] in ("s", "b")
        if c[0] == "s":
            return r[0] == "b"
        return r[1] == c[1]

    h, k = labels(hidden_dims), labels(role_dims)
    one = np.ones((len(h), 1), bool)
    A = np.concatenate([np.array([[allowed(r, c) for c in h] for r in h]), one], 1)
    X = np.concatenate([np.array([[r == c for c in h] for r in k]), np.ones((len(k), 1), bool)], 1)
    R = np.array([[allowed(r, c) for c in k] for r in k])
    return A, X, R


def dims(cfg):
    """(K, H, n, O) of a configuration: roles, latent width, numbers per
    observable, observables."""
    rd, hd, m = cfg["role_dims"], cfg["hidden_dims"], cfg["number_of_objects"]
    return (rd[0] + m * (rd[1] + rd[2]), hd[0] + m * (hd[1] + hd[2]),
            cfg["obs_shape"][1], cfg["obs_shape"][0])


def priors(cfg, dtype, device):
    """The fixed priors of the configuration's model, and its masks as
    tensors: the DMBD defaults (unit-scale Wisharts with nu = dim + 2, the
    emissions' prior scale divided by K^2, Gamma(2, 2) row precisions,
    transition pseudo-counts 1.5 on the diagonal and 0.5 off it where the
    role mask allows, 0.5 for the initial role)."""
    K, H, n, _ = dims(cfg)
    A_mask, X_mask, R_mask = masks(cfg["role_dims"], cfg["hidden_dims"],
                                   cfg["number_of_objects"])
    t = dict(dtype=dtype, device=device)
    eyeK = torch.eye(K, **t)
    return dict(
        A_mask=torch.as_tensor(A_mask, device=device),
        X_mask=torch.as_tensor(X_mask, device=device),
        x0_invU0=torch.eye(H, **t), x0_nu0=torch.tensor(H + 2.0, **t),
        A_alpha0=torch.full((H,), 2.0, **t), A_beta0=torch.full((H,), 2.0, **t),
        B_invU0=torch.eye(n, **t).expand(K, n, n) / K ** 2,
        B_nu0=torch.full((K,), n + 2.0, **t),
        trans0=(eyeK + 0.5) * torch.as_tensor(R_mask, **t),
        init0=torch.full((K,), 0.5, **t),
    )


def draws(cfg, generator, dtype=torch.float32):
    """The random part of a model's starting posteriors, drawn from
    ``generator`` on its device and returned in ``dtype``: the means of A
    and B, the Gamma rates of A's row precisions and the Dirichlet
    pseudo-counts.  The program and the reference both start from these
    numbers (``start`` gives the rest)."""
    K, H, n, _ = dims(cfg)
    t = dict(dtype=torch.float64, device=generator.device)
    pr = priors(cfg, torch.float64, generator.device)

    def randn(*s):
        return torch.randn(s, generator=generator, **t)

    def rand(*s):
        return torch.rand(s, generator=generator, **t)

    out = dict(
        A_mu=randn(H, H + 1) / math.sqrt(H + 1) * pr["A_mask"],
        A_alpha=pr["A_alpha0"] + rand(H), A_beta=pr["A_beta0"] + rand(H),
        B_mu=randn(K, n, H + 1) / math.sqrt(H + 1) * pr["X_mask"][:, None, :],
        trans=pr["trans0"] * (1.0 + rand(K, K)), init=pr["init0"] * (1.0 + rand(K)),
    )
    return {k: v.to(dtype) for k, v in out.items()}


def start(cfg, drawn, dtype, device):
    """The whole starting state from the drawn leaves: every other
    posterior equals its prior (x_{-1}'s mean is 0), and the emissions' row
    covariance and precision start as the identity on the columns each role
    reads."""
    K, H, n, _ = dims(cfg)
    pr = priors(cfg, dtype, device)
    t = dict(dtype=dtype, device=device)
    Xm = torch.diag_embed(pr["X_mask"].to(dtype))
    st = dict(
        x0_mu=torch.zeros(H, **t), x0_lambda=torch.tensor(1.0, **t),
        x0_invU=pr["x0_invU0"], x0_nu=pr["x0_nu0"],
        A_invV=torch.eye(H + 1, **t), A_V=torch.eye(H + 1, **t),
        B_invV=Xm, B_V=Xm.clone(), B_invU=pr["B_invU0"].clone(), B_nu=pr["B_nu0"].clone(),
    )
    st.update({k: v.to(**t) for k, v in drawn.items()})
    return st


# ------------------------------------------------------------------- KL terms
def kl_wishart(invU, nu, invU0, nu0):
    d = invU.shape[-1]
    U = inv(invU)
    return (nu0 / 2 * (logdet(invU) - logdet(invU0)) + nu / 2 * (invU0 * U).sum((-1, -2))
            - nu * d / 2 + mvlgamma(nu0 / 2, d) - mvlgamma(nu / 2, d)
            + (nu - nu0) / 2 * mvdigamma(nu / 2, d))


def kl_gamma(a, b, a0, b0):
    return ((a - a0) * torch.digamma(a) - torch.lgamma(a) + torch.lgamma(a0)
            + a0 * (torch.log(b) - torch.log(b0)) + a * (b0 / b - 1))


def kl_dirichlet(a, a0):
    """Over the last axis; entries with a0 == 0 (masked) drop out."""
    on = a0 > 0
    lg = lambda x: torch.where(on, torch.lgamma(torch.where(on, x, 1.0)), 0.0)
    dg = torch.where(on, torch.digamma(torch.where(on, a, 1.0)), 0.0)
    s, s0 = a.sum(-1), a0.sum(-1)
    return (torch.lgamma(s) - lg(a).sum(-1) - torch.lgamma(s0) + lg(a0).sum(-1)
            + ((a - a0) * (dg - torch.digamma(s)[..., None])).sum(-1))


def dirichlet_loggeomean(a):
    return torch.where(a > 0, torch.digamma(torch.where(a > 0, a, 1.0)), -math.inf) \
        - torch.digamma(a.sum(-1, keepdim=True))


# ------------------------------------------------------------------- smoothers
def role_smoother(L, l0, obs):
    """Forward-backward over chains z_{-1} ~ l0, z_t | z_{t-1} ~ L, with
    log-likelihoods obs (T, ..., K).  Returns the marginals p (T, ..., K),
    the pair counts summed over t = 0..T-1 (with z_{-1} -> z_0) and the
    marginal of z_{-1}, both summed over the chains."""
    T = obs.shape[0]
    lse = torch.logsumexp
    fw, a = [], l0.expand(obs.shape[1:])
    for t in range(T):
        a = lse(a[..., :, None] + L, -2) + obs[t]
        a = a - lse(a, -1, keepdim=True)
        fw.append(a)
    bw, b = [None] * T, torch.zeros_like(obs[0])
    bw[T - 1] = b
    for t in range(T - 1, 0, -1):
        b = lse(L + (obs[t] + b)[..., None, :], -1)
        b = b - lse(b, -1, keepdim=True)
        bw[t - 1] = b
    fw, bw = torch.stack(fw), torch.stack(bw)
    p = torch.softmax(fw + bw, -1)
    prev = torch.cat([l0.expand((1,) + obs.shape[1:]), fw[:-1]], 0)
    xi = prev[..., :, None] + L + (obs + bw)[..., None, :]
    xi = torch.softmax(xi.flatten(-2), -1).unflatten(-1, L.shape)
    SEzz = xi.sum(tuple(range(xi.ndim - 2)))
    SEz0 = xi[0].sum(-1).sum(tuple(range(xi.ndim - 3)))
    return p, SEzz, SEz0


def latent_smoother(Lam0, eta0, res0, invQ, QA, ATQA, elogdet_invQ, Lam_l, eta_l, res_l):
    """Information filter and smoother of x_t = A [x_{t-1}; 1] + noise with
    the expected natural parameters of the dynamics, from x_{-1} with
    precision Lam0 and linear term eta0, and per-time observation messages
    (Lam_l (T, B, H, H), eta_l (T, B, H), res_l (T, B)).  Returns the
    smoothed means and covariances (T, B, H...), the sum over t of the pair
    covariances Cov(x_{t-1}, x_t) (x_{-1} included), x_{-1}'s posterior
    mean and covariance, and each trajectory's log-normalizer."""
    T, B, H = eta_l.shape
    Axx, Axu, Auu = ATQA[:H, :H], ATQA[:H, H], ATQA[H, H]
    Qx, Qu = QA[:, :H], QA[:, H]
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    Lam = Lam0.expand(B, H, H)
    eta = eta0.expand(B, H)
    res = res0.expand(B)
    logZ = torch.zeros(B, dtype=eta_l.dtype, device=eta_l.device)
    fLam, feta = [], []
    for t in range(T):
        P = Lam + Axx
        S = inv(P)
        m = eta - Axu
        Lam_new = sym(Lam_l[t] + invQ - Qx @ S @ mT(Qx))
        eta_new = eta_l[t] + Qu + mv(Qx @ S, m)
        res = res + res_l[t] - 0.5 * Auu + 0.5 * elogdet_invQ \
            + 0.5 * (m * mv(S, m)).sum(-1) - 0.5 * logdet(P)
        mu = mv(inv(Lam_new), eta_new)
        post = -0.5 * (mu * eta_new).sum(-1) + 0.5 * logdet(Lam_new) - 0.5 * H * LOG2PI
        logZ = logZ + res - post
        res, Lam, eta = post, Lam_new, eta_new
        fLam.append(Lam)
        feta.append(eta)
    G = torch.zeros_like(Lam)
    g = torch.zeros_like(eta)
    mus, Sigmas = [None] * T, [None] * T
    cross = torch.zeros_like(Lam)
    for t in range(T - 1, -1, -1):
        Sig = inv(fLam[t] + G)
        Sigmas[t], mus[t] = Sig, mv(Sig, feta[t] + g)
        D = invQ + Lam_l[t] + G
        prevLam = fLam[t - 1] if t > 0 else Lam0.expand(B, H, H)
        J = torch.cat([torch.cat([prevLam + Axx, -mT(Qx).expand(B, H, H)], -1),
                       torch.cat([-Qx.expand(B, H, H), D], -1)], -2)
        cross = cross + inv(J)[:, :H, H:]
        Dinv = inv(D)
        G = Axx - mT(Qx) @ Dinv @ Qx
        g = -Axu + mv(mT(Qx) @ Dinv, Qu + eta_l[t] + g)
    Sig0 = inv(G + Lam0)
    mu0 = mv(Sig0, g + eta0)
    return torch.stack(mus), torch.stack(Sigmas), cross, mu0, Sig0, logZ


# ------------------------------------------------------------------- one sweep
def constrain_to_mask(mu, invV, row_var, mask):
    """The mean of a matrix-normal posterior with row covariance diag(row_var)
    and column precision invV, conditioned on the entries outside ``mask``
    being zero."""
    idx = torch.nonzero(~mask.reshape(-1))[:, 0]
    if idx.numel() == 0:
        return mu
    U, V = torch.diag(row_var), inv(invV).contiguous()
    cov = torch.kron(U, V)[idx[:, None], idx[None, :]]
    gam = torch.zeros_like(mu).reshape(-1)
    gam[idx] = torch.linalg.solve(cov, mu.reshape(-1)[idx])
    return (mu - U @ gam.reshape(mu.shape) @ V) * mask


def sweep(st, y, pr, lr):
    """One sweep from state ``st`` on data y (T, B, O, n); returns the new
    state (with the role marginals ``p`` and latent posterior ``px_mu``,
    ``px_Sigma``) and the ELBO.  ``st`` holds ``px_mu``/``px_Sigma`` from the
    previous sweep, or neither before the first."""
    T, Bn, O, n = y.shape
    K, H = st["B_mu"].shape[0], st["A_mu"].shape[0]
    dt = y.dtype
    Xm, Am = pr["X_mask"].to(dt), pr["A_mask"]
    if "px_mu" in st:
        mx, Sx = st["px_mu"], st["px_Sigma"]
    else:
        mx = y.new_zeros(T, Bn, H)
        Sx = torch.eye(H, dtype=dt, device=y.device).expand(T, Bn, H, H)
    ones = y.new_ones(T, Bn, 1)

    def emission_moments(mu, V, invU, nu):
        U = inv(invU)
        W = nu[:, None, None] * U                                  # <Sigma^-1> (K, n, n)
        WB = W @ mu                                                # (K, n, H + 1)
        BWB = n * V + mT(mu) @ WB                                  # (K, H + 1, H + 1)
        eld = n * math.log(2) - logdet(invU) + mvdigamma(nu / 2, n)
        return W, WB, BWB, eld

    # role E-step on the previous latent posterior
    W, WB, BWB, eld = emission_moments(st["B_mu"], st["B_V"], st["B_invU"], st["B_nu"])
    mX = torch.cat([mx, ones], -1)                                 # (T, B, H + 1)
    XX = mX[..., :, None] * mX[..., None, :]
    XX[..., :H, :H] += Sx
    logits = (-0.5 * torch.einsum("tboi,kij,tboj->tbok", y, W, y)
              + torch.einsum("tboi,kij,tbj->tbok", y, WB, mX)
              - 0.5 * torch.einsum("tbij,kij->tbk", XX, BWB)[:, :, None, :]
              + 0.5 * eld - 0.5 * n * LOG2PI)
    L, l0 = dirichlet_loggeomean(st["trans"]), dirichlet_loggeomean(st["init"])
    p, SEzz, SEz0 = role_smoother(L, l0, logits)

    # role M-step: the two Dirichlets, then the emissions given p
    trans = lr * (SEzz + pr["trans0"]) + (1 - lr) * st["trans"]
    init = lr * (SEz0 + pr["init0"]) + (1 - lr) * st["init"]
    N = p.sum((0, 1, 2))
    SExx = torch.einsum("tbok,tbij->kij", p, XX) * Xm[:, :, None] * Xm[:, None, :]
    SEyx = torch.einsum("tbok,tboi,tbj->kij", p, y, mX) * Xm[:, None, :]
    SEyy = torch.einsum("tbok,tboi,tboj->kij", p, y, y)
    invV = torch.eye(H + 1, dtype=dt, device=y.device) + SExx
    mu = SEyx @ inv(invV) * Xm[:, None, :]
    B_invU = lr * (pr["B_invU0"] + SEyy - mu @ invV @ mT(mu)) + (1 - lr) * st["B_invU"]
    B_nu = lr * (pr["B_nu0"] + N) + (1 - lr) * st["B_nu"]
    B_invV = sym(lr * invV + (1 - lr) * st["B_invV"])
    B_mu = (lr * mu + (1 - lr) * st["B_mu"]) * Xm[:, None, :]
    B_V = inv(B_invV)

    # latent E-step: role-averaged messages from the updated emissions
    W, WB, BWB, eld = emission_moments(B_mu, B_V, B_invU, B_nu)
    d = y[..., None, :] - B_mu[:, :, H]                            # (T, B, O, K, n)
    Wd = torch.einsum("kij,tbokj->tboki", W, d)
    Lam_l = torch.einsum("tbok,kij->tbij", p, BWB[:, :H, :H])
    eta_l = (torch.einsum("tbok,kji,tbokj->tbi", p, B_mu[:, :, :H], Wd)
             - n * torch.einsum("tbok,ki->tbi", p, B_V[:, :H, H]))
    res_l = torch.einsum("tbok,tbok->tb", p, -0.5 * (d * Wd).sum(-1) - 0.5 * n * B_V[:, H, H]
                         - 0.5 * n * LOG2PI + 0.5 * eld)
    g = st["A_alpha"] / st["A_beta"]
    invQ, QA = torch.diag(g), g[:, None] * st["A_mu"]
    ATQA = H * st["A_V"] + mT(st["A_mu"]) @ QA
    elogdet_invQ = (torch.log(st["A_alpha"]) - torch.log(st["A_beta"])).sum()
    x0_W = st["x0_nu"] * inv(st["x0_invU"])
    x0_eta = x0_W @ st["x0_mu"]
    x0_eld = H * math.log(2) - logdet(st["x0_invU"]) + mvdigamma(st["x0_nu"] / 2, H)
    x0_res = (-0.5 * (st["x0_mu"] @ x0_eta + H / st["x0_lambda"]) + 0.5 * x0_eld
              - 0.5 * H * LOG2PI)
    mu_s, Sig_s, cross, mu0, Sig0, logZ = latent_smoother(
        x0_W, x0_eta, x0_res, invQ, QA, ATQA, elogdet_invQ, Lam_l, eta_l, res_l)

    # ELBO: the updated role nodes' KLs, x_{-1}'s and A's before their update
    KL = (0.5 * (1 / st["x0_lambda"] - 1 + torch.log(st["x0_lambda"])) * H
          + 0.5 * st["x0_mu"] @ x0_W @ st["x0_mu"]
          + kl_wishart(st["x0_invU"], st["x0_nu"], pr["x0_invU0"], pr["x0_nu0"]))
    KL = KL + (H / 2 * logdet(st["A_invV"]) - H * (H + 1) / 2
               + 0.5 * H * torch.diagonal(st["A_V"]).sum()
               + 0.5 * (st["A_mu"] * QA).sum()
               + kl_gamma(st["A_alpha"], st["A_beta"], pr["A_alpha0"], pr["A_beta0"]).sum())
    KL = KL + (n / 2 * logdet(B_invV) - n * (H + 1) / 2
               + 0.5 * n * torch.diagonal(B_V, dim1=-2, dim2=-1).sum(-1)
               + 0.5 * torch.diagonal(mT(B_mu) @ W @ B_mu, dim1=-2, dim2=-1).sum(-1)
               + kl_wishart(B_invU, B_nu, pr["B_invU0"], pr["B_nu0"])).sum()
    KL = KL + kl_dirichlet(trans, pr["trans0"]).sum() + kl_dirichlet(init, pr["init0"])
    Lnew = dirichlet_loggeomean(trans)
    contrib = torch.where(torch.isfinite(Lnew), Lnew * SEzz, 0.0).sum() \
        + (dirichlet_loggeomean(init) * SEz0).sum()
    ent = torch.where(p > 1e-8, p * torch.log(torch.where(p > 1e-8, p, 1.0)), 0.0).sum()
    elbo = logZ.sum() - KL + contrib - ent

    # latent M-step: x_{-1} and A from the smoothed statistics
    SE_x0_x0 = sym((Sig0 + mu0[:, :, None] * mu0[:, None, :]).sum(0))
    SE_x0 = mu0.sum(0)
    SE_x_x = sym(torch.einsum("tbi,tbj->ij", mu_s, mu_s) + Sig_s.sum((0, 1)))
    SE_xp_xp = sym(SE_x_x - (mu_s[-1, :, :, None] * mu_s[-1, :, None, :] + Sig_s[-1]).sum(0)
                   + SE_x0_x0)
    SE_xp_u = mu_s[:-1].sum((0, 1)) + SE_x0
    SE_xp_x = (torch.einsum("tbi,tbj->ij", mu_s[:-1], mu_s[1:]) + cross.sum(0)
               + torch.einsum("bi,bj->ij", mu0, mu_s[0]))
    lam = 1.0 + Bn
    m0 = SE_x0 / lam
    x0_invU = lr * (pr["x0_invU0"] + SE_x0_x0 - lam * torch.outer(m0, m0)) \
        + (1 - lr) * st["x0_invU"]
    Tn = float(T * Bn)
    SExx = sym(torch.cat([torch.cat([SE_xp_xp, SE_xp_u[:, None]], 1),
                          torch.cat([SE_xp_u[None], SE_xp_u.new_full((1, 1), Tn)], 1)], 0))
    SEyx = torch.cat([mT(SE_xp_x), mu_s.sum((0, 1))[:, None]], 1)
    invV = torch.eye(H + 1, dtype=dt, device=y.device) + SExx
    mu = constrain_to_mask(SEyx @ inv(invV), invV, 1.0 / g, Am)
    A_invV = sym(lr * invV + (1 - lr) * st["A_invV"])
    new = dict(
        x0_mu=lr * m0 + (1 - lr) * st["x0_mu"],
        x0_lambda=lr * lam + (1 - lr) * st["x0_lambda"],
        x0_invU=x0_invU, x0_nu=lr * (pr["x0_nu0"] + Bn) + (1 - lr) * st["x0_nu"],
        A_mu=(lr * mu + (1 - lr) * st["A_mu"]) * Am, A_invV=A_invV, A_V=inv(A_invV),
        A_alpha=lr * (pr["A_alpha0"] + Tn / 2) + (1 - lr) * st["A_alpha"],
        A_beta=lr * (pr["A_beta0"] + torch.diagonal(SE_x_x - mu @ invV @ mT(mu)) / 2)
        + (1 - lr) * st["A_beta"],
        B_mu=B_mu, B_invV=B_invV, B_V=B_V, B_invU=B_invU, B_nu=B_nu,
        trans=trans, init=init, p=p, px_mu=mu_s, px_Sigma=Sig_s,
    )
    return new, elbo


def run(cfg, drawn, y, lr, sweeps):
    """``sweeps`` sweeps on y from the starting state of the drawn leaves
    (``draws``), in y's dtype and on its device; returns [(ELBO, state after
    the sweep)]."""
    pr = priors(cfg, y.dtype, y.device)
    st = start(cfg, drawn, y.dtype, y.device)
    out = []
    for _ in range(sweeps):
        st, elbo = sweep(st, y, pr, lr)
        out.append((float(elbo), st))
    return out
