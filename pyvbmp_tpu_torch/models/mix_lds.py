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

``parallel.data_parallel_update`` on a ``("data", "model")`` mesh cuts the
K systems over ``model`` (``_split_systems``): each rank smooths and
updates its block of the systems, and one all_gather a sweep of each
sequence's logZ and each system's KL over ``model`` completes the
responsibilities' softmax and the ELBO over all K.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..dists import Dirichlet
from ..parallel.seq_parallel import _PX_FIELDS, time_sweep
from ..utils.torchutils import at_path, batch_paths, batch_sum, sum_leading, with_batch
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
        # this rank's systems while a split sweep runs, and after it while
        # lds.px holds them (parallel.api._Systems)
        self.time_chunk = self._sweep_systems = self.system_block = None

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
        chunk, systems = lds._sweep_chunk, self._sweep_systems
        logZ_seq = ss["logZ"]
        KL_lds = lds._KL(x0, A, obs_model)
        if chunk is not None:
            # the softmax needs each sequence's whole logZ: complete it over
            # time first; the sums of p and logZ below, alike on every rank of
            # the time line, then count on its first rank alone
            logZ_seq, = chunk.complete_time(logZ_seq)
        if systems is not None:
            # every system's logZ and KL: p, logZ and the ELBO below come out
            # alike on every rank of the model line, over all K
            logZ_seq, KL_lds = systems.whole(logZ_seq, KL_lds, dim=-1)
        log_p = logZ_seq + pi.loggeomean()
        shift = log_p.max(-1, keepdim=True).values
        log_p = log_p - shift
        logZ = (torch.logsumexp(log_p, -1, keepdim=True) + shift)[..., 0]
        p = torch.exp(log_p)
        p = p / p.sum(-1, keepdim=True)
        sums = (sum_leading(p, 1), logZ.sum())
        NA, data = batch_sum(*(sums if chunk is None else chunk.once(*sums)))
        KL = pi.KLqprior() + KL_lds.sum(-1)
        ELBO = data - KL
        pi = pi.ss_update(NA, lr=lr)
        p_lds = p if systems is None else systems.take(p, dim=-1)
        x0, A, stats = lds._ss_update(x0, A, ss, p=p_lds, lr=lr)
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
        self.system_block = self._sweep_systems
        # one host fetch for the whole trajectory
        ELBO_last = float(self.ELBO_save[-1]) if self.ELBO_save else -float("inf")
        for ELBO in torch.stack(ELBOs).cpu().tolist():
            if verbose:
                print("Percent Change in ELBO = %f"
                      % ((ELBO - ELBO_last) / abs(ELBO_last) * 100))
            ELBO_last = ELBO
            self.ELBO_save.append(float(ELBO))
        self.NA = NA

    @contextlib.contextmanager
    def _split_systems(self, systems):
        """The block of a sweep with the K systems cut over a mesh axis
        (``systems``, a ``parallel.api._Systems``): the LDS's nodes hold this
        rank's systems (each field that carries the node's batch, cut by the
        node's own ``batch_shape``; a field held once for every system is
        kept whole) and ``update`` runs on them.  When the block ends the
        nodes are whole again, every rank's systems in one all_gather (tag
        "gather"); lds.px holds this rank's systems (``system_block``) until
        ``parallel.gather_posterior``.  Should the block raise, the nodes
        are restored as they were."""
        lds = self.lds
        if lds.time_mesh is not None:
            raise NotImplementedError(
                "a MixLDS with a time_mesh cannot also cut its systems over a 'model' axis: "
                "the port's mesh is at most 2-D")
        nodes = {name: getattr(lds, name) for name in ("x0", "A", "obs_model")}
        paths = {name: batch_paths(n) for name, n in nodes.items()}
        for name, n in nodes.items():
            setattr(lds, name, with_batch(
                n, {p: systems.take(at_path(n, p)) for p in paths[name]}, systems.size))
        lds.batch_shape, self._sweep_systems = (systems.size,), systems
        try:
            yield
        except BaseException:
            for name, n in nodes.items():
                setattr(lds, name, n)
            raise
        finally:
            lds.batch_shape, self._sweep_systems = (self.num_systems,), None
        keys = [(name, p) for name in nodes for p in paths[name]]
        whole = systems.whole(*(at_path(getattr(lds, name), p) for name, p in keys),
                              tag="gather")
        for name in nodes:
            setattr(lds, name, with_batch(
                getattr(lds, name), {p: x for (k, p), x in zip(keys, whole) if k == name},
                self.num_systems))

    def _whole_systems(self):
        """lds.px over all K systems, where it holds this rank's
        (``system_block``): one all_gather over the split's axis (tag
        "gather"), which every rank of the split makes."""
        lds, systems = self.lds, self.system_block
        px = lds.px
        dim = px.mu.ndim - 3 - len(lds.offset)  # (sample..., system, offset..., h, 1)
        fields = systems.whole(*(getattr(px, f) for f in _PX_FIELDS), dim=dim, tag="gather")
        lds.px = dataclasses.replace(px, **dict(zip(_PX_FIELDS, fields)))
        self.system_block = None

    def KLqprior(self):
        return self.pi.KLqprior() + self.lds.KLqprior().sum(-1)

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)
