"""Plain PyTorch reference of one VB sweep of the recurrent switching linear
dynamical system (rSLDS), and the simulator of its benchmark data.

The model (Linderman, Johnson, Miller, Adams, Blei and Paninski, "Bayesian
learning and inference in recurrent switching linear dynamical systems",
AISTATS 2017; pyVBMP ``models/wip_NLDS.py``): K discrete states s_t over an
h-dimensional latent x_t and n-dimensional observations y_t,

    s_0 ~ Cat(pi0),  s_t | s_{t-1}, x_{t-1} ~ stick-breaking softmax(W_{s_{t-1}} [x_{t-1}; 1])
    x_t | x_{t-1}, s_t ~ N(A_{s_t} [x_{t-1}; 1], Q_{s_t}),  y_t | x_t, s_t ~ N(B_{s_t} [x_t; 1], R_{s_t})

with x_{-1} ~ N(mu, Sigma).  Priors and posteriors: x_{-1}
Normal-inverse-Wishart; A and B Matrix-normal-Wishart per state (a full
Wishart on each noise precision); the transition weights W a Gaussian with
an ARD Gamma precision per weight, fit through the Polya-Gamma bound on the
stick-breaking logistic regression; pi0 Dirichlet.

One sweep (``sweep``), from the state's q(s) = p (T, batch, K):

- q(x): each time step's dynamics and observation potentials mixed under
  p_t, then an information-form filter and smoother, sequential over time
  (``latent_smoother``);
- x_{-1}, A and B updated from the p-weighted moments of q(x);
- q(s): observation and dynamics logits from the updated A and B,
  transition logits from the stick-breaking bound at E[x_{t-1}] (the t = 0
  row the log-geometric mean of pi0, after a uniform pseudo-state), and
  the sequential forward-backward over those per-time elements
  (``driven_forward_backward``);
- the transition weights by two Polya-Gamma iterations on the pairwise
  marginals of q(s) (``gate_update``, the ARD fixed point written out),
  then pi0 from q(s_0);
- the ELBO: the sum over the batch of q(s)'s log-normalizer less the KL
  terms of the updated nodes.

Departures from the published model, as the program fits it: the ELBO
leaves out q(x)'s entropy and the Polya-Gamma bound's terms; q(s) starts
from a draw, half on a random state per segment of max(T // 8, 2) steps
and half uniform, in place of a fit; the q(x) step mixes the natural
parameters under q(s_t) (structured mean field); the ARD fixed point
starts from the weight posterior's stored linear term and adds 1e-6 to the
precision before its first step; the Polya-Gamma c is floored as the
program floors it (``pg_c``); the KL of the weights is the program's
(``dists/mvn_ard.py``).  The NASCAR simulator (``simulate``) draws 10-d
observations as the paper does, from trials of its own length.  Nothing
here imports the program that the benchmark measures.

Tensors carry no singleton axes: x_{-1} (h,), A (K, h, h + 1) and B (K, n,
h + 1) with the bias column last, the weights (K, K - 1, h + 1) (source
state, stick, feature), y (T, batch, n), p (T, batch, K).
"""
from __future__ import annotations

import math

import torch

from .dmbd import LOG2PI, inv, kl_dirichlet, kl_gamma, kl_wishart, logdet, mT, mvdigamma, sym

LOG2 = math.log(2.0)


def dims(cfg):
    """(K, h, n) of a configuration: states, latent width, observation width."""
    return cfg["mixture_dim"], cfg["hidden_dim"], cfg["obs_shape"][-1]


def priors(cfg, dtype, device):
    """The fixed priors of the configuration's model, the program's
    defaults: unit-scale Wisharts with nu = dim + 2 (x_{-1}'s, A's and B's),
    x_{-1}'s mean 0 with lambda 1, zero means and unit column precisions of
    A and B, Gamma(0.5, 0.5) ARD precisions of the weights, pseudo-counts
    0.5 for pi0."""
    K, h, n = dims(cfg)
    t = dict(dtype=dtype, device=device)
    return dict(
        x0_invU0=torch.eye(h, **t), x0_nu0=torch.tensor(h + 2.0, **t),
        A_invU0=torch.eye(h, **t), A_nu0=torch.tensor(h + 2.0, **t),
        B_invU0=torch.eye(n, **t), B_nu0=torch.tensor(n + 2.0, **t),
        T_a0=torch.tensor(0.5, **t), T_b0=torch.tensor(0.5, **t),
        pi0=torch.full((K,), 0.5, **t),
    )


def draws(cfg, traffic, generator, dtype=torch.float32):
    """The random part of a model's starting state, drawn from ``generator``
    on its device and returned in ``dtype``, as the program's constructor
    and its first ``update`` draw them: the means of x_{-1}, A and B; the
    weights' mean, their stored linear term (the first draw of the mean,
    which the constructor replaces by a second scaled one) and their ARD
    Gamma parameters; pi0's pseudo-counts; and q(s) at the traffic's T and
    batch.  The program and the reference both start from these numbers
    (``start`` gives the rest)."""
    K, h, n = dims(cfg)
    T, b = traffic["T"], traffic["batch"]
    g = generator
    t = dict(dtype=torch.float64, device=g.device)

    def randn(*s):
        return torch.randn(s, generator=g, **t)

    def rand(*s):
        return torch.rand(s, generator=g, **t)

    seg = max(T // 8, 2)
    states = torch.randint(0, K, ((T + seg - 1) // seg, b), generator=g, device=g.device)
    hard = torch.nn.functional.one_hot(states.repeat_interleave(seg, 0)[:T], K).to(**t)
    out = dict(
        x0_mu=randn(h),
        A_mu=randn(K, h, h + 1) / math.sqrt(h + 1),
        B_mu=randn(K, n, h + 1) / math.sqrt(h + 1),
        T_invSigmamu=randn(K, K - 1, h + 1),
        T_a=0.5 + rand(K, K - 1, h + 1), T_b=0.5 + rand(K, K - 1, h + 1),
        T_mu=randn(K, K - 1, h + 1) / math.sqrt(h + 1),
        pi0=0.5 * (1.0 + rand(K)),
        p=0.5 * hard + 0.5 / K,
    )
    return {k: v.to(dtype) for k, v in out.items()}


def start(cfg, drawn, dtype, device):
    """The whole starting state from the drawn leaves: every other
    posterior equals its prior, and the column precisions of A and B and
    the weights' precision start as the identity."""
    K, h, n = dims(cfg)
    t = dict(dtype=dtype, device=device)

    def eye(d, *batch):
        return torch.eye(d, **t).expand(batch + (d, d)).clone()

    st = dict(
        x0_lambda=torch.tensor(1.0, **t), x0_invU=eye(h), x0_nu=torch.tensor(h + 2.0, **t),
        A_invV=eye(h + 1, K), A_invU=eye(h, K), A_nu=torch.full((K,), h + 2.0, **t),
        B_invV=eye(h + 1, K), B_invU=eye(n, K), B_nu=torch.full((K,), n + 2.0, **t),
        T_invSigma=eye(h + 1, K, K - 1),
    )
    st.update({k: v.to(**t) for k, v in drawn.items()})
    return st


# ----------------------------------------------------------------- simulator
def simulate(batch, T, n, generator, device, right_turn=math.pi / 24, left_turn=math.pi / 48,
             top_step=0.1, bottom_step=0.25, end=2.0, end_gain=100.0, side_gain=10.0,
             state_noise=0.01, obs_noise=0.1):
    """(T, batch, n) float64 NASCAR trials and their (T, batch) states,
    drawn from ``generator`` on ``device``.  The 2-d latent runs round an
    oval track: state 0 turns clockwise by ``right_turn`` a step about
    (end, 0), state 1 by ``left_turn`` about (-end, 0), state 2 drifts right
    by ``top_step``, state 3 left by ``bottom_step``, each with Gaussian
    noise of std ``state_noise``.  The state at t is drawn from the softmax
    of (end_gain (x - end), end_gain (-x - end), side_gain y, -side_gain y)
    at x_{t-1} = (x, y): a turn past either end, else the side the latent is
    on.  Each trial starts on the top straight at (U(-end, end), 1).  One
    map with orthonormal columns and a standard normal offset takes the
    latent to n numbers, with noise of std ``obs_noise``."""
    f = dict(dtype=torch.float64, device=device)

    def rot(a, c):
        R = torch.tensor([[math.cos(a), math.sin(a)], [-math.sin(a), math.cos(a)]], **f)
        return R, (torch.eye(2, **f) - R) @ torch.tensor([c, 0.0], **f)

    Ar, br = rot(right_turn, end)
    Al, bl = rot(left_turn, -end)
    eye = torch.eye(2, **f)
    A = torch.stack([Ar, Al, eye, eye])                               # (4, 2, 2)
    bias = torch.stack([br, bl, torch.tensor([top_step, 0.0], **f),
                        torch.tensor([-bottom_step, 0.0], **f)])      # (4, 2)
    R = torch.tensor([[end_gain, 0.0], [-end_gain, 0.0], [0.0, side_gain], [0.0, -side_gain]], **f)
    r = torch.tensor([-end_gain * end, -end_gain * end, 0.0, 0.0], **f)

    C = torch.linalg.qr(torch.randn(n, 2, generator=generator, **f))[0]
    d = torch.randn(n, generator=generator, **f)
    x = torch.stack([end * (2 * torch.rand(batch, generator=generator, **f) - 1),
                     torch.ones(batch, **f)], -1)
    gumbel = -torch.log(-torch.log(torch.rand(T, batch, 4, generator=generator, **f)))
    kicks = torch.randn(T, batch, 2, generator=generator, **f)
    noise = torch.randn(T, batch, n, generator=generator, **f)
    xs, ss = [], []
    for t in range(T):
        s = (x @ R.T + r + gumbel[t]).argmax(-1)
        x = (A[s] @ x[..., None])[..., 0] + bias[s] + state_noise * kicks[t]
        xs.append(x)
        ss.append(s)
    x, s = torch.stack(xs), torch.stack(ss)
    return x @ C.T + d + obs_noise * noise, s


# ------------------------------------------------------------------ pieces
def expected_parameters(st, n, h):
    """Each state's expected natural parameters of the dynamics and the
    emissions, and x_{-1}'s."""
    W_A = st["A_nu"][:, None, None] * inv(st["A_invU"])               # <Q^-1> (K, h, h)
    W_B = st["B_nu"][:, None, None] * inv(st["B_invU"])               # <R^-1> (K, n, n)
    x0_W = st["x0_nu"] * inv(st["x0_invU"])
    return dict(
        invQ=W_A,
        ATQA=h * inv(st["A_invV"]) + mT(st["A_mu"]) @ W_A @ st["A_mu"],  # (K, h + 1, h + 1)
        QA=W_A @ st["A_mu"],                                          # (K, h, h + 1)
        elogdet_invQ=h * LOG2 - logdet(st["A_invU"]) + mvdigamma(st["A_nu"] / 2, h),
        W=W_B,
        BWB=n * inv(st["B_invV"]) + mT(st["B_mu"]) @ W_B @ st["B_mu"],  # (K, h + 1, h + 1)
        BW=mT(st["B_mu"]) @ W_B,                                      # (K, h + 1, n)
        elogdet_invR=n * LOG2 - logdet(st["B_invU"]) + mvdigamma(st["B_nu"] / 2, n),
        x0_W=x0_W, x0_eta=x0_W @ st["x0_mu"],
    )


def observation_messages(e, y, h):
    """Each state's information-form message from y_t on x_t: precision
    (K, h, h), linear term (T, B, K, h) and residual (T, B, K)."""
    n = y.shape[-1]
    eta = torch.einsum("kiy,tby->tbki", e["BW"][:, :h], y) - e["BWB"][:, :h, h]
    res = (-0.5 * torch.einsum("tbi,kij,tbj->tbk", y, e["W"], y) - 0.5 * e["BWB"][:, h, h]
           + torch.einsum("ki,tbi->tbk", e["BW"][:, h], y)
           + 0.5 * e["elogdet_invR"] - 0.5 * n * LOG2PI)
    return e["BWB"][:, :h, :h], eta, res


def latent_smoother(Jaa, Jab, Jbb, ha, hb):
    """Sequential information-form filter and smoother of a Gaussian chain
    x_{-1}, x_0, ..., x_{T-1} with per-time pairwise potentials over
    (x_{t-1}, x_t): exp(-a'Jaa a / 2 - a'Jab b - b'Jbb b / 2 + ha'a + hb'b),
    each (T, B, ...), x_{-1}'s prior folded into t = 0.  Returns the
    smoothed means and covariances (T, B, h...), Cov(x_{t-1}, x_t) for
    every t (T, B, h, h), and x_{-1}'s smoothed mean and covariance."""
    T, B, h = ha.shape
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    fJ, fh = [], []
    J, hv = torch.zeros_like(Jaa[0]), torch.zeros_like(ha[0])
    for t in range(T):
        Minv = inv(Jaa[t] + J)
        J = sym(Jbb[t] - mT(Jab[t]) @ Minv @ Jab[t])
        hv = hb[t] - mv(mT(Jab[t]) @ Minv, ha[t] + hv)
        fJ.append(J)
        fh.append(hv)
    bJ, bh = [None] * T, [None] * T
    J, hv = torch.zeros_like(Jaa[0]), torch.zeros_like(ha[0])
    for t in range(T - 1, -1, -1):
        bJ[t], bh[t] = J, hv
        Dinv = inv(Jbb[t] + J)
        J = sym(Jaa[t] - Jab[t] @ Dinv @ mT(Jab[t]))
        hv = ha[t] - mv(Jab[t] @ Dinv, hb[t] + hv)
    Sig0 = inv(J)
    mu0 = mv(Sig0, hv)
    Sig = torch.stack([inv(fJ[t] + bJ[t]) for t in range(T)])
    mu = torch.stack([mv(Sig[t], fh[t] + bh[t]) for t in range(T)])
    cross = []
    for t in range(T):
        prev = fJ[t - 1] if t > 0 else torch.zeros_like(J)
        joint = torch.cat([torch.cat([prev + Jaa[t], Jab[t]], -1),
                           torch.cat([mT(Jab[t]), Jbb[t] + bJ[t]], -1)], -2)
        cross.append(inv(joint)[..., :h, h:])
    return mu, Sig, torch.stack(cross), mu0, Sig0


def driven_forward_backward(trans, init, obs):
    """Forward-backward over per-time elements M_t[i, j] = trans_t[i, j] +
    obs_t[j] (trans (T, B, K, K), obs (T, B, K)) after a state drawn from
    ``init`` (K,).  Returns the marginals p (T, B, K), the pairwise
    marginals xi (T, B, K, K) (xi_0 over the state before t = 0 and s_0)
    and each chain's log-normalizer (B,)."""
    T = obs.shape[0]
    lse = torch.logsumexp
    M = trans + obs[..., None, :]
    fw, a = [], init.expand(obs.shape[1:])
    logZ = torch.zeros(obs.shape[1], dtype=obs.dtype, device=obs.device)
    for t in range(T):
        a = lse(a[..., :, None] + M[t], -2)
        c = lse(a, -1)
        logZ = logZ + c
        a = a - c[..., None]
        fw.append(a)
    bw, b = [None] * T, torch.zeros_like(obs[0])
    for t in range(T - 1, -1, -1):
        bw[t] = b
        b = lse(M[t] + b[..., None, :], -1)
        b = b - lse(b, -1, keepdim=True)
    fw, bw = torch.stack(fw), torch.stack(bw)
    p = torch.softmax(fw + bw, -1)
    prev = torch.cat([init.expand((1,) + obs.shape[1:]), fw[:-1]], 0)
    xi = prev[..., :, None] + M + bw[..., None, :]
    xi = torch.softmax(xi.flatten(-2), -1).unflatten(-1, M.shape[-2:])
    return p, xi, logZ


def stick_breaking(Y):
    """The stick-breaking counts N (the Polya-Gamma b) and Y - N / 2 over
    the first K - 1 sticks of class weights Y (..., K)."""
    N = Y.flip(-1).cumsum(-1).flip(-1)
    return N[..., :-1], (Y - N / 2)[..., :-1]


def pg_c(q):
    """The Polya-Gamma c = sqrt(x' E[w w'] x) from its quadratic form q,
    floored at the dtype's smallest normal number as the program floors it
    (a form near 0 can round below it)."""
    return torch.sqrt(q.clamp_min(torch.finfo(q.dtype).tiny))


def weights_second_moment(st):
    """E[w w'] of each source state's and stick's weights (K, K - 1, p, p)."""
    return inv(st["T_invSigma"]) + st["T_mu"][..., :, None] * st["T_mu"][..., None, :]


def transition_logits(st, feats):
    """log p(s_t = j | s_{t-1} = i, x_{t-1}) by the stick-breaking bound at
    the features [E x_{t-1}; 1] (T, B, h): (T, B, K, K)."""
    K = st["T_mu"].shape[0]
    X = torch.cat([feats, torch.ones_like(feats[..., :1])], -1)
    psi = torch.einsum("ikq,tbq->tbik", st["T_mu"], X)
    pgc = pg_c(torch.einsum("tbp,ikpq,tbq->tbik", X, weights_second_moment(st), X))
    pgb, YmN = stick_breaking(torch.eye(K, dtype=X.dtype, device=X.device))  # (class, stick)
    lcosh = 0.5 * pgc + torch.log1p(torch.exp(-pgc)) - LOG2  # log cosh(c / 2), as the program forms it
    return (torch.einsum("jk,tbik->tbij", YmN, psi) - torch.einsum("jk,tbik->tbij", pgb, lcosh)
            - pgb.sum(-1) * LOG2)


def ard_update(st, SExx, SEx, pr, lr, iters=2):
    """The weights' posterior after the ARD fixed point on the statistics
    SExx (K, K - 1, p, p) and SEx (K, K - 1, p); returns the updated leaves."""
    eye = torch.eye(SExx.shape[-1], dtype=SExx.dtype, device=SExx.device)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    a, b = st["T_a"], st["T_b"]
    Sigma = inv(SExx + (a / b)[..., None] * eye + 1e-6 * eye)
    mu = mv(Sigma, st["T_invSigmamu"])
    for _ in range(iters):
        Ew2 = torch.diagonal(Sigma, dim1=-2, dim2=-1) + mu ** 2
        a = lr * (pr["T_a0"] + 0.5) + (1 - lr) * a
        b = lr * (pr["T_b0"] + 0.5 * Ew2) + (1 - lr) * b
        Sigma = inv(SExx + (a / b)[..., None] * eye)
        mu = mv(Sigma, SEx)
    invSigma = sym((1 - lr) * st["T_invSigma"] + lr * (SExx + (a / b)[..., None] * eye))
    invSigmamu = (1 - lr) * st["T_invSigmamu"] + lr * SEx
    return dict(T_invSigma=invSigma, T_invSigmamu=invSigmamu, T_mu=mv(inv(invSigma), invSigmamu),
                T_a=a, T_b=b)


def gate_update(st, feats, xi, pr, lr, iters=2):
    """The transition weights from the features [E x_{t-1}; 1] (S, B, h) and
    the pairwise marginals xi (S, B, K, K) of t = 1..T-1, by ``iters``
    Polya-Gamma iterations, each an ARD update; returns the updated leaves."""
    X = torch.cat([feats, torch.ones_like(feats[..., :1])], -1)
    pgb, YmN = stick_breaking(xi)                                     # (S, B, K, K - 1)
    SEx = torch.einsum("sbik,sbp->ikp", YmN, X)
    new = {k: st[k] for k in ("T_invSigma", "T_invSigmamu", "T_mu", "T_a", "T_b")}
    for _ in range(iters):
        pgc = pg_c(torch.einsum("sbp,ikpq,sbq->sbik", X, weights_second_moment(new), X))
        Ew = pgb / 2 / pgc * torch.tanh(pgc / 2)
        SExx = torch.einsum("sbik,sbp,sbq->ikpq", Ew, X, X)
        new = ard_update(new, SExx, SEx, pr, lr)
    return new


def kl_terms(st, pr, n, h):
    """The KL of every node from its prior, summed: x_{-1}, A, B, the
    weights (the program's form) and pi0."""
    K = st["A_mu"].shape[0]
    x0_W = st["x0_nu"] * inv(st["x0_invU"])
    kl = (0.5 * (1 / st["x0_lambda"] - 1 + torch.log(st["x0_lambda"])) * h
          + 0.5 * st["x0_mu"] @ x0_W @ st["x0_mu"]
          + kl_wishart(st["x0_invU"], st["x0_nu"], pr["x0_invU0"], pr["x0_nu0"]))
    for name, rows in (("A", h), ("B", n)):
        mu, invV = st[name + "_mu"], st[name + "_invV"]
        W = st[name + "_nu"][:, None, None] * inv(st[name + "_invU"])
        p = mu.shape[-1]
        kl = kl + (rows / 2 * logdet(invV) - rows * p / 2
                   + 0.5 * rows * torch.diagonal(inv(invV), dim1=-2, dim2=-1).sum(-1)
                   + 0.5 * torch.diagonal(mT(mu) @ W @ mu, dim1=-2, dim2=-1).sum(-1)
                   + kl_wishart(st[name + "_invU"], st[name + "_nu"], pr[name + "_invU0"],
                                pr[name + "_nu0"])).sum()
    a, b, mu = st["T_a"], st["T_b"], st["T_mu"]
    kl = kl + (0.5 * (mu ** 2 * a / b).sum() - 0.5 * (torch.log(a) - torch.log(b)).sum()
               + 0.5 * logdet(st["T_invSigma"]).sum()
               + (torch.diagonal(inv(st["T_invSigma"]), dim1=-2, dim2=-1) * a / b).sum()
               + kl_gamma(a, b, pr["T_a0"], pr["T_b0"]).sum())
    return kl + kl_dirichlet(st["pi0"], pr["pi0"])


def _mstep(old, SExx, SEyx, SEyy, N, invU0, nu0, lr):
    """A Matrix-normal-Wishart posterior per state from its sums: (mu,
    invV, invU, nu), each damped by ``lr`` toward ``old``."""
    mu_old, invV_old, invU_old, nu_old = old
    invV = torch.eye(SExx.shape[-1], dtype=SExx.dtype, device=SExx.device) + SExx
    mu = SEyx @ inv(invV)
    invU = invU0 + SEyy - mu @ invV @ mT(mu)
    return (lr * mu + (1 - lr) * mu_old, sym(lr * invV + (1 - lr) * invV_old),
            lr * invU + (1 - lr) * invU_old, lr * (nu0 + N) + (1 - lr) * nu_old)


# ------------------------------------------------------------------ one sweep
def sweep(st, y, pr, lr):
    """One sweep from state ``st`` (its q(s) ``p``) on data y (T, B, n);
    returns the new state (with the new q(s) ``p`` and the latent means
    ``px_mu`` (T, B, h)) and the ELBO."""
    T, Bn, n = y.shape
    K, h = st["A_mu"].shape[:2]
    p = st["p"]
    e = expected_parameters(st, n, h)

    # q(x): the potentials mixed under q(s_t), x_{-1}'s prior folded into t = 0
    iS, eta, res = observation_messages(e, y, h)
    mix = lambda a: torch.einsum("tbk,k...->tb...", p, a)
    Jaa = mix(e["ATQA"][:, :h, :h]).clone()
    Jab = -mT(mix(e["QA"][:, :, :h]))
    Jbb = mix(e["invQ"]) + mix(iS)
    ha = -mix(e["ATQA"][:, :h, h]).clone()
    hb = torch.einsum("tbk,tbki->tbi", p, eta) + mix(e["QA"][:, :, h])
    Jaa[0] += e["x0_W"]
    ha[0] += e["x0_eta"]
    mu, Sig, cross, mu0, Sig0 = latent_smoother(Jaa, Jab, Jbb, ha, hb)
    Exx = Sig + mu[..., :, None] * mu[..., None, :]
    E0 = Sig0 + mu0[..., :, None] * mu0[..., None, :]
    Exx_prev = torch.cat([E0[None], Exx[:-1]], 0)
    mu_prev = torch.cat([mu0[None], mu[:-1]], 0)
    C = cross + mu_prev[..., :, None] * mu[..., None, :]             # E[x_{t-1} x_t']

    # x_{-1}, A and B from the moments, weighted by the input q(s)
    N0 = float(Bn)
    lam = 1.0 + N0
    m0 = mu0.sum(0) / lam
    new = dict(
        x0_lambda=lr * lam + (1 - lr) * st["x0_lambda"], x0_mu=lr * m0 + (1 - lr) * st["x0_mu"],
        x0_invU=lr * (pr["x0_invU0"] + E0.sum(0) - lam * torch.outer(m0, m0))
        + (1 - lr) * st["x0_invU"],
        x0_nu=lr * (pr["x0_nu0"] + N0) + (1 - lr) * st["x0_nu"],
    )
    wsum = lambda spec, *xs: torch.einsum("tbk," + spec, p, *xs)
    Nk = p.sum((0, 1))
    ones = torch.ones_like(mu[..., :1])
    Xp = torch.cat([mu_prev, ones], -1)                                 # [x_{t-1}; 1] means
    XXp = Xp[..., :, None] * Xp[..., None, :]
    XXp[..., :h, :h] = Exx_prev
    Xc = torch.cat([mu, ones], -1)
    XXc = Xc[..., :, None] * Xc[..., None, :]
    XXc[..., :h, :h] = Exx
    x_Xp = torch.cat([mT(C), mu[..., None]], -1)                        # E[x_t [x_{t-1}; 1]']
    A = _mstep((st["A_mu"], st["A_invV"], st["A_invU"], st["A_nu"]),
               wsum("tbij->kij", XXp), wsum("tbij->kij", x_Xp), wsum("tbij->kij", Exx), Nk,
               pr["A_invU0"], pr["A_nu0"], lr)
    B = _mstep((st["B_mu"], st["B_invV"], st["B_invU"], st["B_nu"]),
               wsum("tbij->kij", XXc), wsum("tbi,tbj->kij", y, Xc), wsum("tbi,tbj->kij", y, y),
               Nk, pr["B_invU0"], pr["B_nu0"], lr)
    new.update(zip(("A_mu", "A_invV", "A_invU", "A_nu"), A))
    new.update(zip(("B_mu", "B_invV", "B_invU", "B_nu"), B))

    # q(s) from the updated A and B
    e = expected_parameters(new, n, h)
    iS, eta, res = observation_messages(e, y, h)
    tr = lambda M, X: torch.einsum("kij,tbji->tbk", M, X)
    obs = (res + torch.einsum("tbi,tbki->tbk", mu, eta) - 0.5 * tr(iS, Exx)
           + 0.5 * e["elogdet_invQ"] - 0.5 * h * LOG2PI - 0.5 * tr(e["invQ"], Exx)
           + tr(e["QA"][:, :, :h], C) + torch.einsum("ki,tbi->tbk", e["QA"][:, :, h], mu)
           - 0.5 * tr(e["ATQA"][:, :h, :h], Exx_prev)
           - torch.einsum("ki,tbi->tbk", e["ATQA"][:, :h, h], mu_prev) - 0.5 * e["ATQA"][:, h, h])
    trans = transition_logits(st, mu_prev)
    pi0_lgm = torch.digamma(st["pi0"]) - torch.digamma(st["pi0"].sum())
    trans = torch.cat([pi0_lgm.expand((1, Bn, K, K)), trans[1:]], 0)
    init = torch.full((K,), -math.log(K), dtype=y.dtype, device=y.device)
    ps, xi, logZ = driven_forward_backward(trans, init, obs)

    # the transition weights, then pi0 from q(s_0)
    new.update(gate_update(st, mu_prev[1:], xi[1:], pr, lr))
    new["pi0"] = lr * (ps[0].sum(0) + pr["pi0"]) + (1 - lr) * st["pi0"]
    elbo = logZ.sum() - kl_terms(new, pr, n, h)
    new.update(p=ps, px_mu=mu)
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
