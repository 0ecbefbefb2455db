"""Scan-based Kalman filter + RTS smoother in plane layout (counterpart of
pyvbmp_tpu/ops/parallel_kalman.py, plane form).

Elements are unnormalized Gaussian pairwise potentials over (x_left, x_right):

    phi(a, b) = exp(-1/2 a'Jaa a - a'Jab b - 1/2 b'Jbb b + ha'a + hb'b + logw)

The combine integrates out the shared middle variable, so prefix products
give filtered potentials, suffix products give backward messages, and
marginals, cross-covariances and logZ come out in closed form.  The two
scans go through ``ops.scan.kalman_plane_scan``: the CUDA kernel for tensors
on the card, the plain fold of ``_combine_plane`` on the CPU.  The
cross-covariances are the corrected ones (the JAX package's
``cross_cov_compat=False``).
"""
from __future__ import annotations

import torch

from ..utils import math as um
from ..utils.linalg import mT
from . import planemat as pm
from . import scan


def element_batch_shape(parms, like):
    """Broadcast batch shape of the (T,)+bshape elements and the hidden dim."""
    invQ = parms["invQ"]
    nb = like[0].ndim - 1
    bshape = torch.broadcast_shapes(
        invQ.shape[max(0, invQ.ndim - nb):], like[0].shape[1:]
    )
    return bshape, invQ.shape[-1]


def _build_elements(parms, x0, like, u):
    """Dense pairwise potentials (Jaa, Jab, Jbb, ha, hb, logw), broadcast to
    (T,) + bshape, with the x_{-1} prior folded into element 0."""
    iS_like, iSm_like, Res_like = like
    T = iS_like.shape[0]
    invQ = parms["invQ"]
    bshape, hdim = element_batch_shape(parms, like)

    def bcast(x, shape):
        return x.expand((T,) + tuple(shape))

    Jaa = bcast(parms["ATQA_x_x"], bshape)
    Jab = bcast(-mT(parms["QA_xp_x"]), bshape)
    Jbb = bcast(invQ, bshape) + iS_like
    vshape = (T,) + tuple(bshape[:-1]) + (1,)
    ha = (-parms["ATQA_x_u"] @ u).expand(vshape)
    hb = (iSm_like + parms["QA_xp_u"] @ u).expand(vshape)
    logw = (
        Res_like
        - 0.5 * (mT(u) @ parms["ATQA_u_u"] @ u)[..., 0, 0]
        + 0.5 * parms["ElogdetinvQ"]
        - 0.5 * hdim * um.LOG2PI
    )
    logw = logw.expand((T,) + tuple(bshape[:-2]))

    J0 = x0.EinvSigma()
    h0 = x0.EinvSigmamu()[..., None]
    R0 = (
        -0.5 * x0.EXTinvUX()
        + 0.5 * x0.ElogdetinvSigma()
        - 0.5 * hdim * um.LOG2PI
    )
    Jaa = Jaa.clone()
    ha = ha.clone()
    logw = logw.clone()
    Jaa[0] += J0.expand(Jaa.shape[1:])
    ha[0] += h0.expand(ha.shape[1:])
    logw[0] += R0.expand(logw.shape[1:])
    return (Jaa, Jab, Jbb, ha, hb, logw), bshape, T, hdim


def _combine_plane(e1, e2):
    """Marginalize the middle variable of two adjacent plane potentials."""
    J1aa, J1ab, J1bb, h1a, h1b, w1 = e1
    J2aa, J2ab, J2bb, h2a, h2b, w2 = e2
    h = J1bb.shape[-2]
    M = J1bb + J2aa
    hmid = h1b + h2a
    Minv, logdetM = pm.bsym_inv_and_logdet(M)
    Minv_J1abT = pm.bmm(Minv, J1ab, t_b=True)
    Minv_J2ab = pm.bmm(Minv, J2ab)
    Minv_h = pm.bmv(Minv, hmid)
    Jaa = J1aa - pm.bmm(J1ab, Minv_J1abT)
    Jbb = J2bb - pm.bmm(J2ab, Minv_J2ab, t_a=True)
    Jab = -pm.bmm(J1ab, Minv_J2ab)
    ha = h1a - pm.bmv(J1ab, Minv_h)
    hb = h2b - pm.bmv(J2ab, Minv_h, t_a=True)
    w = (
        w1
        + w2
        + 0.5 * pm.bvdot(hmid, Minv_h)
        - 0.5 * logdetM
        + 0.5 * h * um.LOG2PI
    )
    return (Jaa, Jab, Jbb, ha, hb, w)


def _marginalize_left_plane(e):
    """Integrate out the a-side: a potential over b."""
    Jaa, Jab, Jbb, ha, hb, w = e
    h = Jaa.shape[-2]
    Ainv, logdetA = pm.bsym_inv_and_logdet(Jaa)
    Ainv_Jab = pm.bmm(Ainv, Jab)
    Ainv_ha = pm.bmv(Ainv, ha)
    J = Jbb - pm.bmm(Jab, Ainv_Jab, t_a=True)
    hv = hb - pm.bmv(Jab, Ainv_ha, t_a=True)
    logc = w + 0.5 * pm.bvdot(ha, Ainv_ha) - 0.5 * logdetA + 0.5 * h * um.LOG2PI
    return J, hv, logc


def _marginalize_right_plane(e):
    """Integrate out the b-side: a potential over a."""
    Jaa, Jab, Jbb, ha, hb, w = e
    h = Jbb.shape[-2]
    Dinv, logdetD = pm.bsym_inv_and_logdet(Jbb)
    Dinv_JabT = pm.bmm(Dinv, Jab, t_b=True)
    Dinv_hb = pm.bmv(Dinv, hb)
    J = Jaa - pm.bmm(Jab, Dinv_JabT)
    hv = ha - pm.bmv(Jab, Dinv_hb)
    logc = w + 0.5 * pm.bvdot(hb, Dinv_hb) - 0.5 * logdetD + 0.5 * h * um.LOG2PI
    return J, hv, logc


def _shift(a, up):
    """Shift the time axis: up=True gives a_t <- a_{t+1} with a zero tail,
    up=False gives a_t <- a_{t-1} with a zero head."""
    z = torch.zeros_like(a[:1])
    return torch.cat([a[1:], z], 0) if up else torch.cat([z, a[:-1]], 0)


def _plane_smoother(elems, bshape, T, h):
    (Jaa_d, Jab_d, Jbb_d, ha_d, hb_d, logw_d) = elems
    Jaa = pm.pack(Jaa_d)
    Jab = pm.pack(Jab_d)
    Jbb = pm.pack(Jbb_d)
    ha = pm.pack_vec(ha_d)
    hb = pm.pack_vec(hb_d)
    logw = logw_d.reshape(T, -1).contiguous()
    elems_p = (Jaa, Jab, Jbb, ha, hb, logw)

    prefix = scan.kalman_plane_scan(elems_p)
    suffix = scan.kalman_plane_scan(elems_p, reverse=True)

    # filtered potentials over x_t; backward messages on x_{t-1} from S_t
    Ja, hva, logca = _marginalize_left_plane(prefix)
    Jb_all, hvb_all, _ = _marginalize_right_plane(suffix)
    Jbeta = _shift(Jb_all, up=True)
    hbeta = _shift(hvb_all, up=True)

    # smoothed marginals
    Js = Ja + Jbeta
    hs = hva + hbeta
    Sigma, _ = pm.bsym_inv_and_logdet(Js)
    mu = pm.bmv(Sigma, hs)

    # prior-side marginal q(x_{-1})
    Sigma_x0_x0, _ = pm.bsym_inv_and_logdet(Jb_all[0])
    mu_x0 = pm.bmv(Sigma_x0_x0, hvb_all[0])

    # pairwise cross-covariances Sigma_{t-1,t}
    A = _shift(Ja, up=False) + Jaa
    D = Jbb + Jbeta
    Ainv, _ = pm.bsym_inv_and_logdet(A)
    Ainv_B = pm.bmm(Ainv, Jab)
    Sbb, _ = pm.bsym_inv_and_logdet(pm.bsym(D - pm.bmm(Jab, Ainv_B, t_a=True)))
    Sigma_cross_all = -pm.bmm(Ainv_B, Sbb)

    # total logZ from the last filtered potential
    JaInv, logdetJ = pm.bsym_inv_and_logdet(Ja[-1])
    sol = pm.bmv(JaInv, hva[-1])
    logZ_total = (
        logca[-1]
        + 0.5 * pm.bvdot(hva[-1], sol)
        - 0.5 * logdetJ
        + 0.5 * h * um.LOG2PI
    )

    bout = tuple(bshape[:-2])
    Sigma_cross_d = pm.unpack(Sigma_cross_all, bout)
    return (
        (
            pm.unpack(Sigma, bout),
            pm.unpack_vec(mu, bout),
            pm.unpack(Js, bout),
            pm.unpack_vec(hs, bout),
        ),
        Sigma_cross_d[1:],
        Sigma_cross_d[0],
        Sigma_x0_x0.permute(2, 0, 1).reshape(bout + (h, h)),
        mu_x0.permute(1, 0).reshape(bout + (h, 1)),
        logZ_total.reshape(bout),
    )


def parallel_kalman_smoother(parms, x0, like, u):
    """Same contract as pyvbmp_tpu.ops.parallel_kalman.parallel_kalman_smoother:
    returns ((Sigma, mu, Js, hs), Sigma_cross, Sigma_x0_cross, Sigma_x0_x0,
    mu_x0, logZ_total).

    parms: dict from LinearDynamicalSystems._latent_parms
    like:  (invSigma_like, invSigmamu_like, Residual_like), each (T,)+...
    u:     (T,)+...+(control,1)
    """
    elems, bshape, T, hdim = _build_elements(parms, x0, like, u)
    return _plane_smoother(elems, bshape, T, hdim)
