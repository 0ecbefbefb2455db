"""Tensor-state HMMs: discrete states with several axes, under a full or a
factorized transition tensor (counterpart of pyvbmp_tpu/models/tensor_hmm.py).

``tensor_forward_backward`` is the sequential smoother with tuple state
axes, two Python loops over T in plain PyTorch (the JAX package's two
``lax.scan``s), its filter normalized at each step; it runs no kernel on
either device, as in the JAX package, which has no scan form of it.  The
models loop their sweeps eagerly and fetch the ELBO trajectory from the
device once per ``update``.  Under ``parallel.data_parallel_update`` the
E-step's ``batch_sum`` and the observation node's complete the sums over
the batch (``torchutils.completes_sums``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dists import Dirichlet, NormalInverseWishart
from ..transforms.transition import HierarchicalTransition, Transition
from ..utils import math as um
from ..utils.torchutils import (
    batch_sum, completes_sums, default_device, replace, sum_leading,
)


def _unsq_right(x, ed):
    return x.reshape(x.shape + (1,) * ed)


def _unsq_left(x, ed):
    return x.reshape(x.shape[: x.ndim - ed] + (1,) * ed + x.shape[x.ndim - ed:])


def tensor_forward_backward(trans_lgm, init_lgm, obs_logits, event_dim, ptemp=1.0):
    """The smoother of an HMM whose state has ``event_dim`` axes.

    trans_lgm:  batch + event + event (broadcastable)  <log p(z'|z)>
    init_lgm:   batch + event
    obs_logits: (T,) + sample + batch + event
    Returns (p, SEzz, SEz0, logZ): the smoothed posteriors (ptemp-sharpened),
    the summed two-slice statistics, the initial step's and logZ.
    """
    ed = event_dim
    left = tuple(range(-2 * ed, -ed))
    right = tuple(range(-ed, 0))
    lse = um.stable_logsumexp

    def fwd(logits, obs_t):
        """The next filtered log posterior, normalized over the state axes,
        and its log normalizer."""
        f = lse(_unsq_right(logits, ed) + _unsq_left(obs_t, ed) + trans_lgm, left)
        c = lse(f, right, keepdim=True)
        return f - c, c

    # Each step's filter is normalized and its normalizer summed into logZ.
    # The JAX package carries the unnormalized filter, which grows like the
    # log-likelihood (~1e4 at the HMM-core widths): in float32 its rounding
    # shifts p by ~3e-4.  Every output below is invariant to a per-step
    # shift of the filter, so the two forms agree in exact arithmetic.
    fw, logZ = fwd(init_lgm, obs_logits[0])
    fw = [fw.expand(torch.broadcast_shapes(fw.shape, obs_logits.shape[1:]))]
    for t in range(1, obs_logits.shape[0]):
        f, c = fwd(fw[-1], obs_logits[t])
        fw.append(f)
        logZ = logZ + c
    fw_logits = torch.stack(fw)
    logZ = logZ.reshape(logZ.shape[: logZ.ndim - ed])

    def xi_of(logits_t, sm_next):
        temp = _unsq_right(logits_t, ed) + trans_lgm
        return (temp - lse(temp, left, keepdim=True)) + _unsq_left(sm_next, ed)

    def pair(xi):
        return torch.exp(xi - lse(xi, left + right, keepdim=True))

    SEzz = fw_logits.new_zeros(torch.broadcast_shapes(
        fw_logits.shape[1:] + fw_logits.shape[-ed:], trans_lgm.shape))
    smoothed = [fw_logits[-1]]
    for t in range(fw_logits.shape[0] - 2, -1, -1):
        xi = xi_of(fw_logits[t], smoothed[-1])
        smoothed.append(lse(xi, right))
        SEzz = SEzz + pair(xi)
    smoothed = torch.stack(smoothed[::-1])

    xi = xi_of(init_lgm, smoothed[0])
    SEz0 = lse(xi, right)
    SEz0 = torch.exp(SEz0 - lse(SEz0, right, keepdim=True))
    SEzz = SEzz + pair(xi)

    p = torch.exp(um.stable_softmax(smoothed, right) / ptemp)
    p = p / p.sum(right, keepdim=True)
    return p, SEzz, SEz0, logZ


def _like(n):
    """A tensor of node ``n``: the dtype and device the model is built in."""
    return next(v for v in (getattr(n, f.name) for f in dataclasses.fields(n))
                if isinstance(v, torch.Tensor))


class Tensor_HMM:
    """HMM with a tensor-valued state under a full ``Transition`` node."""

    transition_cls = Transition

    def __init__(self, obs_dist, event_shape, ptemp=1.0, prior_parms=None, *,
                 generator=None, dtype=None, device=None):
        """The JAX package's signature; ``generator`` (for the Dirichlets'
        initial draws), ``dtype`` and ``device`` are keyword-only.  The
        model (``obs_dist`` with it) goes to ``device``, the card unless the
        caller asks for another.  ``obs_dist``'s trailing batch dims are the
        state's axes, ``event_shape``."""
        if len(obs_dist.batch_shape) < len(event_shape):
            raise ValueError(f"obs_dist's batch shape {obs_dist.batch_shape} does not end "
                             f"in the state's axes {tuple(event_shape)}")
        obs_dist = obs_dist.to(default_device(device), dtype)
        like = _like(obs_dist)
        self.obs_dist = obs_dist
        self.dim = int(np.prod(event_shape))
        self.event_dim = len(event_shape)
        self.event_shape = tuple(event_shape)
        self.batch_shape = tuple(obs_dist.batch_shape[: -len(event_shape)])
        self.batch_dim = len(self.batch_shape)
        if prior_parms is None and self.transition_cls is Transition:
            eye = torch.eye(self.dim, dtype=like.dtype, device=like.device)
            prior_parms = {"alpha": eye.reshape(self.event_shape + self.event_shape) + 0.5}
        kw = dict(generator=generator, dtype=like.dtype, device=like.device)
        self.transition = self.transition_cls.create(
            self.event_shape, self.batch_shape, prior_parms=prior_parms, **kw)
        self.initial = Dirichlet.create(self.event_shape, self.batch_shape, **kw)
        self.p = None
        self.NA = None
        self.ptemp = ptemp
        self.logZ = torch.full((), -float("inf"), dtype=like.dtype, device=like.device)
        self.ELBO_last = -float("inf")
        self.ELBO_save = []

    def to(self, device=None, dtype=None):
        """Move the nodes and the state in place; returns self."""
        for name in ("obs_dist", "transition", "initial"):
            setattr(self, name, getattr(self, name).to(device, dtype))
        for name in ("p", "NA", "logZ"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, v.to(device=device, dtype=dtype))
        return self

    def _state_view(self, obs_dist, X):
        """X with a 1 for each state axis before the observation's event."""
        ed = obs_dist.event_dim
        return X.reshape(X.shape[: X.ndim - ed] + self.event_dim * (1,) + X.shape[X.ndim - ed:])

    def _estep(self, transition, initial, obs_dist, X):
        logits = obs_dist.Elog_like(self._state_view(obs_dist, X))
        p, SEzz, SEz0, logZ = tensor_forward_backward(
            transition.loggeomean(), initial.loggeomean(), logits, self.event_dim, self.ptemp)
        keep = self.batch_dim + self.event_dim
        # the E-step's sums over the batch, for the M-steps and the ELBO
        SEzz, SEz0, NA, logZ = batch_sum(
            sum_leading(SEzz, keep + self.event_dim), sum_leading(SEz0, keep),
            sum_leading(p.sum(0), keep), sum_leading(logZ, self.batch_dim))
        return p, SEzz, SEz0, NA, logZ

    def _post_markov_update(self, transition):
        return transition

    def _KL(self, transition, initial, obs_dist):
        return (obs_dist.KLqprior().sum(tuple(range(-self.event_dim, 0)))
                + transition.KLqprior() + initial.KLqprior())

    def _vb_step(self, transition, initial, obs_dist, X, lr, beta):
        p, SEzz, SEz0, NA, logZ = self._estep(transition, initial, obs_dist, X)
        transition = self._post_markov_update(transition.ss_update(SEzz, lr=lr, beta=beta))
        initial = initial.ss_update(SEz0, lr=lr, beta=beta)
        with completes_sums(obs_dist):
            obs_dist = obs_dist.raw_update(self._state_view(obs_dist, X), p=p, lr=lr,
                                           beta=beta)
        ELBO = logZ - self._KL(transition, initial, obs_dist)
        return transition, initial, obs_dist, p, NA, logZ, ELBO

    def update(self, X, iters=1, T=None, lr=1.0, beta=None, verbose=False):
        """``iters`` VB sweeps on X: (T,) + sample + batch + the observation's
        event shape."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        ELBOs = []
        for _ in range(iters):
            (self.transition, self.initial, self.obs_dist, self.p, self.NA, self.logZ,
             ELBO) = self._vb_step(self.transition, self.initial, self.obs_dist, X, lr, beta)
            ELBOs.append(ELBO)
        # one host fetch for the whole trajectory
        for ELBO in torch.stack(ELBOs).cpu():
            if verbose:
                print("Percent Change in ELBO = ",
                      (ELBO - self.ELBO_last) / abs(self.ELBO_last) * 100)
            self.ELBO_last = ELBO
            self.ELBO_save.append(float(ELBO.sum()))

    def update_states(self, X, T=None):
        self.p, SEzz, SEz0, NA, logZ = self._estep(
            self.transition, self.initial, self.obs_dist, X)
        self.logZ = logZ
        return SEzz, SEz0, NA, logZ

    def update_markov_parms(self, SEzz, SEz0, lr=1.0, beta=None):
        self.transition = self._post_markov_update(
            self.transition.ss_update(SEzz, lr=lr, beta=beta))
        self.initial = self.initial.ss_update(SEz0, lr=lr, beta=beta)

    def update_obs_parms(self, X, lr=1.0, beta=None):
        with completes_sums(self.obs_dist):
            self.obs_dist = self.obs_dist.raw_update(
                self._state_view(self.obs_dist, X), p=self.p, lr=lr, beta=beta)

    def KLqprior(self):
        return self._KL(self.transition, self.initial, self.obs_dist)

    def ELBO(self):
        return self.logZ - self.KLqprior()

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)


class HHMM(Tensor_HMM):
    """Hierarchical HMM: a chain-factorized transition tensor."""

    transition_cls = HierarchicalTransition

    def __init__(self, obs_dist, event_dim=2, event_shape=(), ptemp=1.0, *, generator=None,
                 dtype=None, device=None):
        if event_dim < 2:
            raise ValueError("HHMM: event_dim must be > 1; use HMM instead")
        if event_shape == ():
            event_shape = tuple(obs_dist.batch_shape[-event_dim:])
        super().__init__(obs_dist, event_shape, ptemp=ptemp, prior_parms=None,
                         generator=generator, dtype=dtype, device=device)


class Factorial_HMM(Tensor_HMM):
    """Tensor HMM with a factorized transition prior; the transition
    posterior is projected back onto the factorized form after every
    M-step."""

    def __init__(self, num_factors, factor_shape, event_shape, batch_shape=(), *,
                 generator=None, dtype=None, device=None):
        dtype = dtype or torch.get_default_dtype()
        obs_dist = NormalInverseWishart.create(
            tuple(event_shape), batch_shape=tuple(batch_shape) + num_factors * tuple(factor_shape),
            generator=generator, dtype=dtype, device=default_device(device))
        self.num_factors = num_factors
        self.factor_shape = tuple(factor_shape)
        fl = len(factor_shape)
        alpha = 0.0
        self.marg_sum_list = []
        for i in range(num_factors):
            eshape = i * fl * (1,) + tuple(factor_shape) + (num_factors - i - 1) * fl * (1,)
            d = int(np.prod(eshape))
            alpha = alpha + torch.eye(d, dtype=dtype).reshape(eshape + eshape) + 0.5
            self.marg_sum_list.append(
                tuple(x for x in range(-2 * len(eshape), 0) if (2 * eshape)[x] == 1))
        alpha = alpha / alpha.max() * 2
        super().__init__(obs_dist, event_shape=num_factors * tuple(factor_shape),
                         prior_parms={"alpha": alpha}, generator=generator, dtype=dtype,
                         device=device)

    def _post_markov_update(self, transition):
        """Project the transition posterior onto the factorized form:
        alpha <- sum_i alpha.mean(factor i's marginal dims) / num_factors."""
        alpha = transition.alpha
        alpha_new = 0.0
        for dims in self.marg_sum_list:
            alpha_new = alpha_new + (alpha.mean(dims, keepdim=True) if dims else alpha) \
                / self.num_factors
        return replace(transition, alpha=alpha_new.expand(alpha.shape).clone())
