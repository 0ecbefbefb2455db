"""Dynamic Markov Blanket Discovery (counterpart of pyvbmp_tpu/models/dmbd.py).

An LDS whose observation model is an ARHMM over "roles"; the latent x is
partitioned into (environment s, boundary b, internal z) blocks per object,
enforced by structural masks on the dynamics (A_mask), the emission (B_mask)
and the role transitions (role_mask).  Coordinate ascent interleaves the role
smoother and the Kalman smoother.  With ``parallel_scan=True`` both are
scan pairs (a log-semiring scan pair and a Gaussian potential scan pair:
four scan kernels a sweep on the card); with ``parallel_scan=False``, the
JAX package's default, both are the sequential smoothers (the HMM's
``forward_backward`` and the LDS ``forward_backward_loop`` with the
reference's cross-covariance line, ``cross_cov_compat=True``), which run no
kernel.

With ``unique_obs=True`` each observable gets its own role model: the
role HMM is batched over the ``n_obs`` observables and, as in the JAX
package, has no role ``transition_mask``.  ``Elog_like`` is the data bound
from fresh role and latent E-steps; ``plot_observation`` and
``plot_transition`` draw the labelled emission and transition heatmaps
(matplotlib is imported only inside them).

``time_mesh`` (the time-sharded smoothers) and a non-empty ``batch_shape``
raise ``NotImplementedError``; the JAX package's own update fails on a
non-empty ``batch_shape`` (a broadcasting error in its role E-step), so
there is nothing to port against.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dists import NormalInverseWishart
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..transforms import MatrixNormalGamma
from ..utils import math as um
from ..utils.linalg import mT, psd_inv_and_logdet
from ..utils.torchutils import brole_avg, default_device, replace, sum_leading
from .arhmm import ARHMM_prXRY
from .hmm import smoother_dispatch
from .lds import LinearDynamicalSystems


def _agg_if_no_backend():
    """Select the Agg backend for headless figure saves without replacing a
    backend the caller already has loaded."""
    import sys

    if "matplotlib.pyplot" in sys.modules:
        return  # a backend is already live; fig.savefig works on any backend
    import matplotlib

    try:
        matplotlib.use("Agg", force=False)
    except Exception:
        pass


def _host(x):
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _block(A, B, C, D):
    return np.block([[A, B], [C, D]])


def one_object_mask(hidden_dims, role_dims, control_dim, obs_dim, regression_dim):
    """Standard masks for a single object."""
    hd, rd = hidden_dims, role_dims
    As = np.concatenate(
        [np.ones((hd[0], hd[0] + hd[1])), np.zeros((hd[0], hd[2]))], -1
    )
    Ab = np.ones((hd[1], hd[0] + hd[1] + hd[2]))
    Az = np.concatenate(
        [np.zeros((hd[2], hd[0])), np.ones((hd[2], hd[1] + hd[2]))], -1
    )
    if len(hd) == 4:
        As = np.concatenate([As, np.zeros((hd[0], hd[3]))], -1)
        Ab = np.concatenate([Ab, np.zeros((hd[1], hd[3]))], -1)
        Az = np.concatenate([Az, np.zeros((hd[2], hd[3]))], -1)
        Ag = np.concatenate(
            [np.zeros((hd[3], sum(hd[:-1]))), np.ones((hd[3], hd[3]))], -1
        )
        A_mask = np.concatenate([As, Ab, Az, Ag], -2)
    else:
        A_mask = np.concatenate([As, Ab, Az], -2)
    A_mask = np.concatenate(
        [A_mask, np.ones(A_mask.shape[:-1] + (control_dim,))], -1
    ) > 0

    def emission_rows(role_n, active):
        out = []
        for j, h in enumerate(hd[:3]):
            out.append(
                np.ones((role_n, obs_dim, h))
                if j in active
                else np.zeros((role_n, obs_dim, h))
            )
        return np.concatenate(out, -1)

    Bs = emission_rows(rd[0], {0})
    Bb = emission_rows(rd[1], {1})
    Bz = emission_rows(rd[2], {2})
    if len(hd) == 4:
        Bs = np.concatenate([Bs, np.ones((rd[0], obs_dim, hd[3]))], -1)
        Bb = np.concatenate([Bb, np.ones((rd[1], obs_dim, hd[3]))], -1)
        Bz = np.concatenate([Bz, np.ones((rd[2], obs_dim, hd[3]))], -1)
    B_mask = np.concatenate([Bs, Bb, Bz], -3)
    B_mask = np.concatenate(
        [B_mask, np.ones(B_mask.shape[:-1] + (regression_dim,))], -1
    ) > 0

    role_dim = sum(rd[:3])
    rs = np.concatenate(
        [np.ones((rd[0], rd[0] + rd[1])), np.zeros((rd[0], rd[2]))], -1
    )
    rb = np.ones((rd[1], role_dim))
    rz = np.concatenate(
        [np.zeros((rd[2], rd[0])), np.ones((rd[2], rd[1] + rd[2]))], -1
    )
    role_mask = np.concatenate([rs, rb, rz], -2)
    return A_mask, B_mask, role_mask


def n_object_mask(n, hidden_dims, role_dims, control_dim, obs_dim, regression_dim):
    """Masks for n objects sharing one environment."""
    hd, rd = hidden_dims, role_dims
    bz = np.ones((hd[1] + hd[2], hd[1] + hd[2]))
    notbz = np.zeros_like(bz)
    bz_mask = _block(bz, notbz, notbz, bz)
    sb = np.ones((hd[0], hd[1]))
    sz = np.zeros((hd[0], hd[2]))
    sbz_mask = np.concatenate([sb, sz], -1)
    for _ in range(n - 2):
        bz_mask = _block(
            bz_mask,
            np.zeros((bz_mask.shape[0], bz.shape[0])),
            np.zeros((bz.shape[0], bz_mask.shape[0])),
            bz,
        )
    for _ in range(n - 1):
        sbz_mask = np.concatenate([sbz_mask, sb, sz], -1)
    A_mask = _block(np.ones((hd[0], hd[0])), sbz_mask, sbz_mask.T, bz_mask)
    A_mask = np.concatenate([A_mask, np.ones(A_mask.shape[:-1] + (control_dim,))], -1)

    Bb = np.concatenate([np.ones((rd[1], hd[1])), np.zeros((rd[1], hd[2]))], -1)
    Bz = np.concatenate([np.zeros((rd[2], hd[1])), np.ones((rd[2], hd[2]))], -1)
    Bbz = np.concatenate([Bb, Bz], -2)
    B_mask = np.ones((rd[0], hd[0]))
    for _ in range(n):
        B_mask = _block(
            B_mask,
            np.zeros((B_mask.shape[0], Bbz.shape[1])),
            np.zeros((Bbz.shape[0], B_mask.shape[1])),
            Bbz,
        )
    B_mask = np.broadcast_to(
        B_mask[:, None, :], (B_mask.shape[0], obs_dim, B_mask.shape[1])
    )
    B_mask = np.concatenate(
        [B_mask, np.ones(B_mask.shape[:-1] + (regression_dim,))], -1
    )

    bz = np.ones((rd[1] + rd[2], rd[1] + rd[2]))
    notbz = np.zeros_like(bz)
    bz_mask = _block(bz, notbz, notbz, bz)
    sb = np.ones((rd[0], rd[1]))
    sz = np.zeros((rd[0], rd[2]))
    sbz_mask = np.concatenate([sb, sz], -1)
    for _ in range(n - 2):
        bz_mask = _block(
            bz_mask,
            np.zeros((bz_mask.shape[0], bz.shape[0])),
            np.zeros((bz.shape[0], bz_mask.shape[0])),
            bz,
        )
    for _ in range(n - 1):
        sbz_mask = np.concatenate([sbz_mask, sb, sz], -1)
    role_mask = _block(np.ones((rd[0], rd[0])), sbz_mask, sbz_mask.T, bz_mask)
    return A_mask > 0, B_mask > 0, role_mask > 0


class DynamicMarkovBlanketDiscovery(LinearDynamicalSystems):
    def __init__(
        self,
        obs_shape,
        role_dims,
        hidden_dims,
        control_dim=0,
        regression_dim=0,
        batch_shape=(),
        number_of_objects=1,
        unique_obs=False,
        parallel_scan=False,
        time_mesh=None,
        *,
        generator=None,
        dtype=None,
        device=None,
    ):
        """The JAX package's signature and defaults; ``generator``, ``dtype``
        and ``device`` (the card unless the caller asks for another) are
        keyword-only."""
        if tuple(batch_shape):
            raise NotImplementedError(
                "a non-empty DMBD batch_shape is not ported: the JAX package's own "
                "update fails on it in its role E-step (DMBD((4, 2), (1, 1, 1), (2, 1, 1), "
                "batch_shape=(2,)) raises 'ValueError: Incompatible shapes for "
                "broadcasting: shapes=[(15, 2, 2, 4, 1, 2, 2), (2, 3, 2, 2)]'), so "
                "there is no reference to hold the port to"
            )
        if time_mesh is not None:
            raise NotImplementedError("time_mesh (the time-sharded smoothers) is not ported")
        device = default_device(device)
        dtype = dtype or torch.get_default_dtype()
        control_dim = control_dim + 1
        regression_dim = regression_dim + 1
        obs_dim = obs_shape[-1]

        if number_of_objects > 1:
            hidden_dim = hidden_dims[0] + number_of_objects * (
                hidden_dims[1] + hidden_dims[2]
            )
            role_dim = role_dims[0] + number_of_objects * (role_dims[1] + role_dims[2])
            A_mask, B_mask, role_mask = n_object_mask(
                number_of_objects, hidden_dims, role_dims, control_dim, obs_dim,
                regression_dim,
            )
        else:
            hidden_dim = sum(hidden_dims)
            role_dim = sum(role_dims)
            A_mask, B_mask, role_mask = one_object_mask(
                hidden_dims, role_dims, control_dim, obs_dim, regression_dim
            )

        self.number_of_objects = number_of_objects
        self.unique_obs = unique_obs
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = obs_dim
        self.event_dim = len(obs_shape)
        self.n_obs = obs_shape[0]
        self.role_dims = tuple(role_dims)
        self.role_dim = role_dim
        self.hidden_dims = tuple(hidden_dims)
        self.hidden_dim = hidden_dim
        self.control_dim = control_dim
        self.regression_dim = regression_dim
        self.batch_shape = ()
        self.batch_dim = 0
        self.offset = (1,) * (len(obs_shape) - 1)
        # the smoothers' flags, as in the JAX package: the scan-based
        # smoothers compute the corrected cross-covariances, the sequential
        # ones reproduce the reference's
        self.parallel_scan = parallel_scan
        self.time_mesh = None
        self.cross_cov_compat = not parallel_scan
        self.expand_to_batch = False
        self.ELBO_save = []
        self.ELBO_last = -float("inf")
        self.iters = 0
        self.px = None
        self.logZ = torch.full((), -float("inf"), dtype=dtype, device=device)

        self.x0 = NormalInverseWishart.create(
            self.offset + (hidden_dim,), self.batch_shape, generator=generator,
            dtype=dtype, device=device,
        )
        self.x0 = replace(self.x0, mu=torch.zeros_like(self.x0.mu))

        self.A = MatrixNormalGamma.create(
            self.offset + (hidden_dim, hidden_dim + control_dim),
            self.batch_shape,
            mask=A_mask,
            uniform_precision=False,
            generator=generator,
            dtype=dtype,
            device=device,
        )

        if unique_obs:
            # one role model per observable, with no role transition_mask (as
            # in the JAX package)
            self.obs_model = ARHMM_prXRY(
                role_dim,
                obs_dim,
                hidden_dim,
                regression_dim,
                batch_shape=self.batch_shape + (self.n_obs,),
                X_mask=B_mask[None].sum(-2, keepdims=True) > 0,
                generator=generator,
                dtype=dtype,
                device=device,
            )
        else:
            self.obs_model = ARHMM_prXRY(
                role_dim,
                obs_dim,
                hidden_dim,
                regression_dim,
                batch_shape=self.batch_shape,
                X_mask=B_mask.sum(-2, keepdims=True) > 0,
                transition_mask=torch.as_tensor(role_mask > 0, device=device),
                generator=generator,
                dtype=dtype,
                device=device,
            )

        # B-prior tweak: scale invU_0 down by role_dim^2 (reference DMBD:81-84)
        B = self.obs_model.obs_dist
        invU_0 = B.invU.invU_0 / float(role_dim**2)
        U, logdet = psd_inv_and_logdet(invU_0)
        self.obs_model.obs_dist = replace(
            B,
            invU=replace(
                B.invU,
                invU_0=invU_0,
                invU=invU_0,
                U=U,
                logdet_invU_0=logdet,
                logdet_invU=logdet,
            ),
        )
        # NOTE: the reference also sets ``B.ptemp = 20.0`` (DMBD:85), but the
        # HMM smoother reads the temperature from the obs_model (=1.0), so the
        # attribute is dead, as in the JAX package.

    def to(self, device=None, dtype=None):
        """Move the model's nodes and state in place; returns self."""
        self.x0 = self.x0.to(device, dtype)
        self.A = self.A.to(device, dtype)
        self.obs_model.to(device, dtype)
        if self.px is not None:
            self.px = self.px.to(device, dtype)
        self.logZ = self.logZ.to(device=device, dtype=dtype)
        return self

    # -------------------------------------------------------- role E/M pieces
    def _px4r(self, px, r):
        target_shape = tuple(r.shape[:-2])
        h = self.hidden_dim
        return MVN_vf(
            mu=px.mu.expand(target_shape + (h, 1)),
            Sigma=px.Sigma.expand(target_shape + (h, h)),
            invSigmamu=px.invSigmamu.expand(target_shape + (h, 1)),
            invSigma=px.invSigma.expand(target_shape + (h, h)),
        ).unsqueeze(-self.obs_model.event_dim - 2)

    def _init_px(self, r):
        h = self.hidden_dim
        lead = tuple(r.shape[:-3]) + (1,)
        eye = torch.eye(h, dtype=r.dtype, device=r.device).expand(lead + (h, h))
        zer = r.new_zeros(lead + (h, 1))
        return MVN_vf(mu=zer, Sigma=eye, invSigmamu=zer, invSigma=eye)

    def _role_estep(self, transition, initial, B, px, y, r):
        """obs_model.update_states on (px4r, r, y)."""
        om = self.obs_model
        unsdim = om.event_dim + 2
        px4r = self._px4r(px, r)
        XRY = (px4r, r.unsqueeze(-unsdim), y.unsqueeze(-unsdim))
        logits = om._obs_logits(B, XRY)
        fb = smoother_dispatch(self)
        p, SEzz, SEz0, _ = fb(
            transition.loggeomean(), initial.loggeomean(), logits, om.ptemp
        )
        keep = om.batch_dim + om.event_dim
        return p, sum_leading(SEzz, keep + 1), sum_leading(SEz0, keep)

    def log_likelihood_function_role(self, B, p, Y, R):
        """Role-averaged observation messages for the Kalman E-step."""
        om = self.obs_model
        unsdim = om.event_dim + 2
        invSigma, invSigmamu, Residual = _arhmm_elog_like_X(
            om, B, (Y.unsqueeze(-unsdim), R.unsqueeze(-unsdim)), p
        )
        return (
            invSigma.sum(-unsdim, keepdim=True),
            invSigmamu.sum(-unsdim, keepdim=True),
            Residual.sum(-unsdim + 2, keepdim=True),
        )

    # ------------------------------------------------------------- full sweep
    def _latents_given_p(self, x0, A, B, p, y, u, r):
        """Latent E-step given role assignments p: (px, sufficient stats)."""
        like = self.log_likelihood_function_role(B, p, y, r)
        px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, logZ = (
            self._smoother(self._latent_parms(A), x0, like, u)
        )
        ss = self._latent_suffstats(
            px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, y, u, r, logZ
        )
        return px, ss

    def _dmbd_step(self, x0, A, transition, initial, B, px, y, u, r, lr,
                   latent_iters=1):
        om = self.obs_model
        # warm-up passes (latent_iters - 1): roles from a fresh px, then the
        # latents given them (reference DMBD.update:191-194)
        for _ in range(latent_iters - 1):
            p, _, _ = self._role_estep(transition, initial, B, self._init_px(r), y, r)
            px, _ = self._latents_given_p(x0, A, B, p, y, u, r)
        # role E-step
        p, SEzz, SEz0 = self._role_estep(transition, initial, B, px, y, r)
        # role M-step
        transition = transition.ss_update(SEzz, lr=lr)
        initial = initial.ss_update(SEz0, lr=lr)
        unsdim = om.event_dim + 2
        px4r = self._px4r(px, r)
        XRY = (px4r, r.unsqueeze(-unsdim), y.unsqueeze(-unsdim))
        B = om._obs_update(B, XRY, p, lr, None)
        # latent E-step with updated roles
        px, ss = self._latents_given_p(x0, A, B, p, y, u, r)
        logZ = ss["logZ"]
        # ELBO
        KL = x0.KLqprior() + A.KLqprior()
        for _ in range(len(self.offset)):
            if KL.ndim > 0:
                KL = KL[..., 0] if KL.shape[-1] == 1 else KL
        KL = KL + (
            B.KLqprior().sum(-1)
            + transition.KLqprior().sum(-1)
            + initial.KLqprior()
        )
        lgm = transition.loggeomean()
        contrib = torch.where(
            torch.isfinite(lgm), lgm * SEzz, torch.zeros_like(lgm)
        ).sum()
        contrib = contrib + (initial.loggeomean() * SEz0).sum()
        safe_p = torch.where(p > 1e-8, p, torch.ones_like(p))
        contrib = contrib - torch.where(
            p > 1e-8, p * torch.log(safe_p), torch.zeros_like(p)
        ).sum()
        ELBO = sum_leading(logZ, self.batch_dim).sum() - KL.sum() + contrib
        # latent M-step
        x0, A, _ = self._ss_update(x0, A, ss, lr=lr)
        return x0, A, transition, initial, B, px, p, logZ, ELBO

    def update(self, y, u=None, r=None, iters=1, latent_iters=1, lr=1.0,
               verbose=False):
        """``iters`` VB-EM sweeps on data y: (T,) + sample + obs_shape, each
        after ``latent_iters - 1`` warm-up passes of the role and latent
        E-steps (the JAX package's signature)."""
        y, u, r = self.reshape_inputs(y, u, r)
        om = self.obs_model
        px = self._init_px(r) if self.px is None else self.px
        x0, A = self.x0, self.A
        transition, initial, B = om.transition, om.initial, om.obs_dist
        ELBOs = []
        for _ in range(iters):
            x0, A, transition, initial, B, px, p, logZ, ELBO = self._dmbd_step(
                x0, A, transition, initial, B, px, y, u, r, lr, latent_iters
            )
            ELBOs.append(ELBO)
        self.x0, self.A = x0, A
        om.transition, om.initial, om.obs_dist = transition, initial, B
        om.p, self.px, self.logZ = p, px, logZ
        self.iters += iters
        # one host fetch for the whole trajectory
        for e in torch.stack(ELBOs).cpu().tolist():
            if verbose:
                print(
                    "Percent Change in ELBO = ",
                    (e - self.ELBO_last) / abs(self.ELBO_last) * 100,
                )
            self.ELBO_last = float(e)
            self.ELBO_save.append(float(e))

    def Elog_like(self, y, u=None, r=None, latent_iters=1, lr=1.0):
        """Data likelihood bound: ``latent_iters`` role and latent E-steps
        from a fresh px, returning logZ minus the role-assignment entropy
        (sample-shaped).  ``lr`` is unused, as in the JAX package."""
        y, u, r = self.reshape_inputs(y, u, r)
        om = self.obs_model
        transition, initial, B = om.transition, om.initial, om.obs_dist
        px = self._init_px(r)
        for _ in range(latent_iters):
            p, _, _ = self._role_estep(transition, initial, B, px, y, r)
            px, ss = self._latents_given_p(self.x0, self.A, B, p, y, u, r)
        safe_p = torch.where(p > 1e-8, p, torch.ones_like(p))
        ent = torch.where(p > 1e-8, p * torch.log(safe_p), torch.zeros_like(p))
        return ss["logZ"] - ent.sum(0).sum((-1, -2))

    # KLqprior is the LDS's: x0's, A's and the role HMM's KLqprior()

    def ELBO(self):
        """The ELBO of the last sweep, as the JAX package returns it."""
        return self.ELBO_last

    # ------------------------------------------------------------ assignments
    def assignment_pr(self):
        """Posterior probabilities of (s, b_1, z_1, ..., b_n, z_n) per
        observable, summed over each block's roles."""
        p_role = self.obs_model.assignment_pr()
        rd = self.role_dims
        out = [p_role[..., : rd[0]].sum(-1, keepdim=True)]
        for n in range(self.number_of_objects):
            start = rd[0] + n * (rd[1] + rd[2])
            out.append(p_role[..., start : start + rd[1]].sum(-1, keepdim=True))
            out.append(
                p_role[..., start + rd[1] : start + rd[1] + rd[2]].sum(-1, keepdim=True)
            )
        return torch.cat(out, -1)

    def particular_assignment_pr(self):
        """Probabilities of (environment, object 1, ..., object n), each
        object's blanket and internal roles together."""
        p_sbz = self.assignment_pr()
        out = [p_sbz[..., :1]]
        for n in range(self.number_of_objects):
            out.append(p_sbz[..., 2 * n + 1 : 2 * n + 3].sum(-1, keepdim=True))
        return torch.cat(out, -1)

    def particular_assignment(self):
        return self.particular_assignment_pr().argmax(-1)

    def assignment(self):
        return self.assignment_pr().argmax(-1)

    # ---------------------------------------------------------- introspection
    def _sbz_labels(self):
        labels = ["S "] + ["B ", "Z "] * self.number_of_objects
        if self.number_of_objects > 1:
            labels = [
                lab if i == 0 else lab + str((i + 1) // 2)
                for i, lab in enumerate(labels)
            ]
        return labels

    def _annotate_sbz(self, ax, dims, axis="x"):
        """Coloured S/B/Z block labels at the block centres."""
        for i, label in enumerate(self._sbz_labels()):
            c = "red" if i == 0 else ("green" if i % 2 == 1 else "blue")
            pos = dims[0] / 2.0 + i * (dims[1] + dims[2]) / 2.0
            if i > 0:
                pos = pos - 0.5
            if axis == "x":
                ax.text(pos, -1.5, label, color=c, ha="center", va="center",
                        fontsize=10, weight="bold")
            else:
                ax.text(-1.5, pos, label, color=c, ha="center", va="center",
                        fontsize=10, weight="bold", rotation=90)

    def plot_observation(self, path=None):
        """Labelled |<B>| heatmap (roles x latent blocks), summed over the
        observables.  Headless-safe; saves to ``path`` if given and returns
        the figure."""
        if path is not None:
            _agg_if_no_backend()
        from matplotlib import pyplot as plt

        B = np.abs(_host(self.obs_model.obs_dist.mean())).sum(-2)
        B = B.reshape(-1, B.shape[-1])
        fig, ax = plt.subplots()
        ax.imshow(B)
        self._annotate_sbz(ax, self.hidden_dims, "x")
        self._annotate_sbz(ax, self.role_dims, "y")
        ax.axis("off")
        if path is not None:
            fig.savefig(path, bbox_inches="tight")
            plt.close(fig)
        return fig

    def plot_transition(self, type="obs", use_mask=False, path=None):
        """Labelled heatmap of the role transition posterior (``type='obs'``)
        or of the latent dynamics |<A>| (``type='latent'``); ``use_mask``
        shows the structural mask instead.  Headless-safe; saves to ``path``
        if given and returns the figure."""
        if path is not None:
            _agg_if_no_backend()
        from matplotlib import pyplot as plt

        if type == "obs":
            M = (
                self.obs_model.transition_mask
                if use_mask
                else self.obs_model.transition.mean()
            )
            dims = self.role_dims
        else:
            M = self.A.mask if use_mask else self.A.mean().abs()
            dims = self.hidden_dims
        M = np.squeeze(_host(M))
        if M.ndim != 2:
            raise ValueError(
                "plot_transition needs a single matrix; got shape "
                f"{M.shape} after squeezing: select one batch entry first"
            )
        if type != "obs":
            # drop the control/bias columns so the S/B/Z x-axis labels line up
            M = M[:, : M.shape[0]]
        fig, ax = plt.subplots()
        ax.imshow(M)
        self._annotate_sbz(ax, dims, "x")
        self._annotate_sbz(ax, dims, "y")
        ax.axis("off")
        if path is not None:
            fig.savefig(path, bbox_inches="tight")
            plt.close(fig)
        return fig


# The latent messages in centred form.  With a regressor (the bias column)
# the observations' mean is carried by the emission's last columns, and the
# expanded quadratics y'<S^-1>y, y'<S^-1>b and b'<S^-1>b are each far
# larger than their sum when a channel's spread is small against its mean
# (the Newton's-cradle balls at rest: means ~1, spreads ~1e-4).  In float32
# their sum keeps ~3 digits of the Kalman messages there; the residual
# d = y - <b>r formed first keeps float32 close to float64.  The two forms
# are equal in exact arithmetic (float64 agrees with the JAX package's
# expanded form to ~1e-11).


def _arhmm_elog_like_X(om, B, YR, p):
    """ARHMM_prXRY.Elog_like_X with explicit obs_dist B (no pad_X) and
    assignments p, in centred form: the likelihood of the x block in
    natural parameters with the regressors R conditioned out."""
    Y, R = YR
    p1 = om.p1
    d = Y - B.mu[..., p1:] @ R
    Wd = B.EinvSigma() @ d
    invSigma_x_x = B.EXTinvUX()[..., :p1, :p1]
    invSigmamu_x = mT(B.mu[..., :p1]) @ Wd - B.n * B.V[..., :p1, p1:] @ R
    Residual = (
        -0.5 * (d * Wd).sum((-1, -2))
        - 0.5 * B.n * (mT(R) @ B.V[..., p1:, p1:] @ R)[..., 0, 0]
        - 0.5 * B.n * um.LOG2PI
        + 0.5 * B.ElogdetinvSigma()
    )
    invSigma_x_x = brole_avg(invSigma_x_x, p)
    invSigmamu_x = brole_avg(invSigmamu_x, p)
    Residual = (Residual * p).sum(-1)
    return invSigma_x_x, invSigmamu_x, Residual
