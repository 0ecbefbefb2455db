"""Mixture of linear dynamical systems (counterpart of
pyvbmp_tpu/models/mix_lds.py): K LDSs batched over a system axis, with
Dirichlet responsibilities from each system's logZ.

``parallel_scan=True`` runs the scan-based smoother (at h <= 3 the lane-form
CUDA kernel, two launches per sweep) with the corrected cross-covariances;
the default is the sequential smoother with the reference's
cross-covariance quirk.  A ``time_mesh`` (a ``parallel.Mesh``) cuts the
smoother's time axis across the mesh's ranks, also with the corrected
cross-covariances, and ``update`` runs the sweep on this rank's rows of
T: each sequence's logZ is completed over the time axis (one all_reduce)
before the responsibilities' softmax, and the components' px stay this
rank's rows (``CHUNK_STATE``).
"""
from __future__ import annotations

import torch

from ..dists import Dirichlet
from ..parallel.seq_parallel import time_sweep
from ..utils.torchutils import batch_sum, sum_leading
from .lds import LinearDynamicalSystems


class MixtureofLinearDynamicalSystems:
    CHUNK_STATE = {"lds.px": "time", "p": "seq", "logZ": "seq"}

    def __init__(self, num_systems, obs_shape, hidden_dim, control_dim,
                 regression_dim, parallel_scan=False, time_mesh=None,
                 generator=None, dtype=None, device=None):
        self.num_systems = num_systems
        self.lds = LinearDynamicalSystems(
            obs_shape,
            hidden_dim,
            control_dim,
            regression_dim,
            latent_noise="independent",
            batch_shape=(num_systems,),
            cross_cov_compat=not (parallel_scan or time_mesh is not None),
            parallel_scan=parallel_scan,
            time_mesh=time_mesh,
            generator=generator,
            dtype=dtype,
            device=device,
        )
        self.lds.expand_to_batch = True
        self.pi = Dirichlet.create(
            (num_systems,), generator=generator, dtype=self.lds.x0.mu.dtype,
            device=self.lds.x0.mu.device,  # the LDS resolved the default
        )
        self.ELBO_save = []
        self.p = None
        self.logZ = None

    def to(self, device=None, dtype=None):
        """Move the model's nodes and state in place; returns self."""
        self.lds.to(device, dtype)
        self.pi = self.pi.to(device, dtype)
        if self.p is not None:
            self.p = self.p.to(device, dtype)
        if self.logZ is not None:
            self.logZ = self.logZ.to(device, dtype)
        return self

    def _vb_step(self, x0, A, obs_model, pi, y, u, r, lr):
        lds = self.lds
        px, ss = lds._update_latents(x0, A, obs_model, y, u, r)
        chunk = lds._sweep_chunk
        logZ_seq = ss["logZ"]
        if chunk is not None:
            # the softmax needs each sequence's whole logZ: complete it over
            # time first; the sums of p and logZ below, alike on every rank of
            # the time line, then count on its first rank alone
            logZ_seq, = chunk.complete_time(logZ_seq)
        log_p = logZ_seq + pi.loggeomean()
        shift = log_p.max(-1, keepdim=True).values
        log_p = log_p - shift
        logZ = (torch.logsumexp(log_p, -1, keepdim=True) + shift)[..., 0]
        p = torch.exp(log_p)
        p = p / p.sum(-1, keepdim=True)
        sums = (sum_leading(p, 1), logZ.sum())
        NA, data = batch_sum(*(sums if chunk is None else chunk.once(*sums)))
        KL = pi.KLqprior() + lds._KL(x0, A, obs_model).sum(-1)
        ELBO = data - KL
        pi = pi.ss_update(NA, lr=lr)
        x0, A, stats = lds._ss_update(x0, A, ss, p=p, lr=lr)
        obs_model = obs_model.ss_update(
            stats["SE_xr_xr"], stats["SE_y_xr"], stats["SE_y_y"], stats["T"], lr
        )
        return x0, A, obs_model, pi, px, p, NA, logZ, ELBO

    def update(self, y, u=None, r=None, iters=1, lr=1.0, verbose=False):
        """``iters`` VB-EM sweeps (one smoother pass each) on data y:
        (T,) + sample + obs_shape."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        lds = self.lds
        y, u, r = lds.reshape_inputs(y, u, r)
        x0, A, obs_model, pi = lds.x0, lds.A, lds.obs_model, self.pi
        ELBOs = []
        with time_sweep(lds, y, lds._n_seq(y), self) as chunk:
            if chunk is not None:
                y, u, r = chunk.take(y), chunk.take(u), chunk.take(r)
            for _ in range(iters):
                x0, A, obs_model, pi, px, p, NA, logZ, ELBO = self._vb_step(
                    x0, A, obs_model, pi, y, u, r, lr
                )
                ELBOs.append(ELBO)
        lds.x0, lds.A, lds.obs_model, lds.px = x0, A, obs_model, px
        self.pi, self.p, self.logZ = pi, p, logZ
        # one host fetch for the whole trajectory
        ELBO_last = float(self.ELBO_save[-1]) if self.ELBO_save else -float("inf")
        for ELBO in torch.stack(ELBOs).cpu().tolist():
            if verbose:
                print("Percent Change in ELBO = %f"
                      % ((ELBO - ELBO_last) / abs(ELBO_last) * 100))
            ELBO_last = ELBO
            self.ELBO_save.append(float(ELBO))
        self.NA = NA

    def KLqprior(self):
        return self.pi.KLqprior() + self.lds.KLqprior().sum(-1)

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)
