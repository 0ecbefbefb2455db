"""Scan-based Kalman filter + RTS smoother (counterpart of
pyvbmp_tpu/ops/parallel_kalman.py: the lane, plane and dense forms).

Elements are unnormalized Gaussian pairwise potentials over (x_left, x_right):

    phi(a, b) = exp(-1/2 a'Jaa a - a'Jab b - 1/2 b'Jbb b + ha'a + hb'b + logw)

The combine integrates out the shared middle variable, so prefix products
give filtered potentials, suffix products give backward messages, and
marginals, cross-covariances and logZ come out in closed form.  The
cross-covariances are the corrected ones (the JAX package's
``cross_cov_compat=False``).

Three layouts, chosen by the hidden dim h as in the JAX package:

- **lane form** (h <= LANE_KALMAN_MAX_H = 3): every matrix is packed by
  components (``ops/smallmat.py``), the combine ``_combine_lane`` is
  straight-line code with closed-form adjugate inverses, and the scans go
  through ``ops.scan.kalman_lane_scan``;
- **plane form** (3 < h <= PLANE_KALMAN_MAX_H = 32): ``(T, h, w, N)``
  planes (``ops/planemat.py``), the combine ``_combine_plane``, scans
  through ``ops.scan.kalman_plane_scan``;
- **dense form** (h > 32): batched ``(..., h, h)`` matrices, the combine
  ``_combine`` (one Cholesky solve against the stacked right-hand sides),
  scans by ``associative_scan``: 2 ceil(log2 T) levels of batched
  ``torch.linalg``, the same code on the CPU and on the card.

The lane and plane scans are the CUDA kernels for tensors on the card and
the plain fold of the combine on the CPU.  The dense form reaches no kernel
in the JAX package either (its Pallas scan refuses (..., h, h) leaves).
"""
from __future__ import annotations

import torch

from ..utils import math as um
from ..utils.linalg import mT, psd_inv, psd_solve_and_logdet
from . import planemat as pm
from . import scan
from . import smallmat as sm

# h <= LANE_KALMAN_MAX_H takes the lane form, h <= PLANE_KALMAN_MAX_H the
# plane form and any larger h the dense form (the JAX package's default gates)
LANE_KALMAN_MAX_H = 3
PLANE_KALMAN_MAX_H = scan.PLANE_MAX_H


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
    """Shift the time axis: up=True gives a_t <- a_{t+1} with a zero tail
    (the JAX package's ``_shift_up``), up=False gives a_t <- a_{t-1} with a
    zero head."""
    z = torch.zeros_like(a[:1])
    return torch.cat([a[1:], z], 0) if up else torch.cat([z, a[:-1]], 0)


# =========================================================== dense layout path
def associative_scan(combine, elems, reverse=False):
    """Inclusive scan of the tuple of tensors ``elems`` over axis 0 in chain
    order (``out[t] = e[0] o ... o e[t]``; reversed, ``e[t] o ... o e[T-1]``),
    by the odd-even recursion of ``jax.lax.associative_scan``: two batched
    ``combine`` calls a level, 2 ceil(log2 T) calls in all."""
    if reverse:
        flip = lambda t: tuple(x.flip(0) for x in t)
        return flip(associative_scan(lambda a, b: combine(b, a), flip(elems)))
    T = elems[0].shape[0]
    if T < 2:
        return elems
    pairs = combine(tuple(x[0:-1:2] for x in elems), tuple(x[1::2] for x in elems))
    odd = associative_scan(combine, pairs)  # prefixes at t = 1, 3, 5, ...
    rest = tuple(x[2::2] for x in elems)
    if rest[0].shape[0]:
        lead = odd if T % 2 else tuple(x[:-1] for x in odd)
        even = combine(lead, rest)
        even = tuple(torch.cat([x[:1], e], 0) for x, e in zip(elems, even))
    else:
        even = tuple(x[:1] for x in elems)
    out = []
    for e, o in zip(even, odd):
        y = e.new_empty((T,) + tuple(e.shape[1:]))
        y[0::2] = e
        y[1::2] = o
        out.append(y)
    return tuple(out)


def _combine(e1, e2):
    """Marginalize the middle variable of two adjacent dense potentials."""
    J1aa, J1ab, J1bb, h1a, h1b, w1 = e1
    J2aa, J2ab, J2bb, h2a, h2b, w2 = e2
    h = J1bb.shape[-1]
    hmid = h1b + h2a
    # one Cholesky solve against the stacked right-hand sides
    rhs = torch.cat([mT(J1ab), J2ab, hmid], -1)
    sol, logdetM = psd_solve_and_logdet(J1bb + J2aa, rhs)
    Minv_J1abT = sol[..., :h]
    Minv_J2ab = sol[..., h: 2 * h]
    Minv_h = sol[..., 2 * h:]
    Jaa = J1aa - J1ab @ Minv_J1abT
    Jbb = J2bb - mT(J2ab) @ Minv_J2ab
    Jab = -J1ab @ Minv_J2ab
    ha = h1a - J1ab @ Minv_h
    hb = h2b - mT(J2ab) @ Minv_h
    w = (
        w1
        + w2
        + 0.5 * (hmid * Minv_h).sum((-1, -2))
        - 0.5 * logdetM
        + 0.5 * h * um.LOG2PI
    )
    return (Jaa, Jab, Jbb, ha, hb, w)


def _marginalize_left(Jaa, Jab, Jbb, ha, hb, w):
    """Integrate out the a-side: a potential over b."""
    h = Jaa.shape[-1]
    sol, logdetA = psd_solve_and_logdet(Jaa, torch.cat([Jab, ha], -1))
    Ainv_Jab = sol[..., :h]
    Ainv_ha = sol[..., h:]
    J = Jbb - mT(Jab) @ Ainv_Jab
    hv = hb - mT(Jab) @ Ainv_ha
    logc = w + 0.5 * (ha * Ainv_ha).sum((-1, -2)) - 0.5 * logdetA + 0.5 * h * um.LOG2PI
    return J, hv, logc


def _marginalize_right(Jaa, Jab, Jbb, ha, hb, w):
    """Integrate out the b-side: a potential over a."""
    h = Jbb.shape[-1]
    sol, logdetD = psd_solve_and_logdet(Jbb, torch.cat([mT(Jab), hb], -1))
    Dinv_JabT = sol[..., :h]
    Dinv_hb = sol[..., h:]
    J = Jaa - Jab @ Dinv_JabT
    hv = ha - Jab @ Dinv_hb
    logc = w + 0.5 * (hb * Dinv_hb).sum((-1, -2)) - 0.5 * logdetD + 0.5 * h * um.LOG2PI
    return J, hv, logc


def _dense_smoother(elems, bshape, T, hdim):
    Jaa, Jab, Jbb, ha, hb, logw = elems
    prefix = associative_scan(_combine, elems)
    suffix = associative_scan(_combine, elems, reverse=True)

    # filtered potentials over x_t; backward messages on x_{t-1} from S_t
    Ja, hva, logca = _marginalize_left(*prefix)
    Jb_all, hvb_all, _ = _marginalize_right(*suffix)
    Jbeta = _shift(Jb_all, up=True)
    hbeta = _shift(hvb_all, up=True)

    # smoothed marginals
    Js = Ja + Jbeta
    hs = hva + hbeta
    Sigma = psd_inv(Js)
    mu = Sigma @ hs

    # prior-side marginal q(x_{-1})
    Sigma_x0_x0 = psd_inv(Jb_all[0])
    mu_x0 = Sigma_x0_x0 @ hvb_all[0]

    # pairwise cross-covariances Sigma_{t-1,t}
    A = _shift(Ja, up=False) + Jaa
    D = Jbb + Jbeta
    Ainv_B = psd_inv(A) @ Jab
    Sbb = psd_inv(D - mT(Jab) @ Ainv_B)
    Sigma_cross_all = -Ainv_B @ Sbb

    # total logZ from the last filtered potential
    sol, logdetJ = psd_solve_and_logdet(Ja[-1], hva[-1])
    logZ_total = (
        logca[-1]
        + 0.5 * (hva[-1] * sol).sum((-1, -2))
        - 0.5 * logdetJ
        + 0.5 * hdim * um.LOG2PI
    )
    return (
        (Sigma, mu, Js, hs),
        Sigma_cross_all[1:],
        Sigma_cross_all[0],
        Sigma_x0_x0,
        mu_x0,
        logZ_total,
    )


# ============================================================ lane layout path
def _combine_lane(h, e1, e2):
    """_combine_plane in component form (ops/smallmat.py packing):
    straight-line elementwise ops, adjugate inverse of M."""
    J1aa, J1ab, J1bb, h1a, h1b, w1 = e1
    J2aa, J2ab, J2bb, h2a, h2b, w2 = e2
    M = sm.sym_add(J1bb, J2aa)
    hmid = h1b + h2a
    Minv, logdetM = sm.sym_inv_and_logdet(h, M)
    Minv_J1abT = sm.mm(h, Minv, J1ab, sym_a=True, t_b=True)
    Minv_J2ab = sm.mm(h, Minv, J2ab, sym_a=True)
    Minv_h = sm.mv(h, Minv, hmid, sym_a=True)
    Jaa = sm.sym_sub(J1aa, sm.mm(h, J1ab, Minv_J1abT, sym_out=True))
    Jbb = sm.sym_sub(J2bb, sm.mm(h, J2ab, Minv_J2ab, t_a=True, sym_out=True))
    Jab = -sm.mm(h, J1ab, Minv_J2ab)
    ha = h1a - sm.mv(h, J1ab, Minv_h)
    hb = h2b - sm.mv(h, J2ab, Minv_h, t_a=True)
    w = (
        w1
        + w2
        + 0.5 * sm.vdot(hmid, Minv_h)
        - 0.5 * logdetM
        + 0.5 * h * um.LOG2PI
    )
    return (Jaa, Jab, Jbb, ha, hb, w)


def _marginalize_left_lane(h, e):
    Jaa, Jab, Jbb, ha, hb, w = e
    Ainv, logdetA = sm.sym_inv_and_logdet(h, Jaa)
    Ainv_Jab = sm.mm(h, Ainv, Jab, sym_a=True)
    Ainv_ha = sm.mv(h, Ainv, ha, sym_a=True)
    J = sm.sym_sub(Jbb, sm.mm(h, Jab, Ainv_Jab, t_a=True, sym_out=True))
    hv = hb - sm.mv(h, Jab, Ainv_ha, t_a=True)
    logc = w + 0.5 * sm.vdot(ha, Ainv_ha) - 0.5 * logdetA + 0.5 * h * um.LOG2PI
    return J, hv, logc


def _marginalize_right_lane(h, e):
    Jaa, Jab, Jbb, ha, hb, w = e
    Dinv, logdetD = sm.sym_inv_and_logdet(h, Jbb)
    Dinv_JabT = sm.mm(h, Dinv, Jab, sym_a=True, t_b=True)
    Dinv_hb = sm.mv(h, Dinv, hb, sym_a=True)
    J = sm.sym_sub(Jaa, sm.mm(h, Jab, Dinv_JabT, sym_out=True))
    hv = ha - sm.mv(h, Jab, Dinv_hb)
    logc = w + 0.5 * sm.vdot(hb, Dinv_hb) - 0.5 * logdetD + 0.5 * h * um.LOG2PI
    return J, hv, logc


def _lane_smoother(elems, bshape, T, h):
    (Jaa_d, Jab_d, Jbb_d, ha_d, hb_d, logw_d) = elems
    Jaa = sm.sym_pack(Jaa_d)
    Jab = sm.gen_pack(Jab_d)
    Jbb = sm.sym_pack(Jbb_d)
    ha = sm.vec_pack(ha_d)
    hb = sm.vec_pack(hb_d)
    logw = logw_d.reshape(T, -1).contiguous()
    elems_l = (Jaa, Jab, Jbb, ha, hb, logw)

    prefix = scan.kalman_lane_scan(elems_l)
    suffix = scan.kalman_lane_scan(elems_l, reverse=True)

    Ja, hva, logca = _marginalize_left_lane(h, prefix)
    Jb_all, hvb_all, _ = _marginalize_right_lane(h, suffix)
    Jbeta = _shift(Jb_all, up=True)
    hbeta = _shift(hvb_all, up=True)

    # smoothed marginals
    Js = sm.sym_add(Ja, Jbeta)
    hs = hva + hbeta
    Sigma, _ = sm.sym_inv_and_logdet(h, Js)
    mu = sm.mv(h, Sigma, hs, sym_a=True)

    # prior-side marginal q(x_{-1})
    Sigma_x0_x0, _ = sm.sym_inv_and_logdet(h, Jb_all[0])
    mu_x0 = sm.mv(h, Sigma_x0_x0, hvb_all[0], sym_a=True)

    # pairwise cross-covariances Sigma_{t-1,t}
    A = sm.sym_add(_shift(Ja, up=False), Jaa)
    D = sm.sym_add(Jbb, Jbeta)
    Ainv, _ = sm.sym_inv_and_logdet(h, A)
    Ainv_B = sm.mm(h, Ainv, Jab, sym_a=True)
    BT_Ainv_B = sm.mm(h, Jab, Ainv_B, t_a=True, sym_out=True)
    Sbb, _ = sm.sym_inv_and_logdet(h, sm.sym_sub(D, BT_Ainv_B))
    Sigma_cross_all = -sm.mm(h, Ainv_B, Sbb, sym_b=True)

    # total logZ from the last filtered potential
    JaInv, logdetJ = sm.sym_inv_and_logdet(h, Ja[-1])
    sol = sm.mv(h, JaInv, hva[-1], sym_a=True)
    logZ_total = (
        logca[-1]
        + 0.5 * sm.vdot(hva[-1], sol)
        - 0.5 * logdetJ
        + 0.5 * h * um.LOG2PI
    )

    bout = tuple(bshape[:-2])
    Sigma_cross_d = sm.gen_unpack(Sigma_cross_all, h, bout)
    return (
        (
            sm.sym_unpack(Sigma, h, bout),
            sm.vec_unpack(mu, bout),
            sm.sym_unpack(Js, h, bout),
            sm.vec_unpack(hs, bout),
        ),
        Sigma_cross_d[1:],
        Sigma_cross_d[0],
        sm.sym_unpack(Sigma_x0_x0, h, bout),
        sm.vec_unpack(mu_x0, bout),
        logZ_total.reshape(bout),
    )


# =========================================================== plane layout path
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


def parallel_kalman_smoother(parms, x0, like, u, lane_form=None, plane_form=None):
    """Same contract as pyvbmp_tpu.ops.parallel_kalman.parallel_kalman_smoother:
    returns ((Sigma, mu, Js, hs), Sigma_cross, Sigma_x0_cross, Sigma_x0_x0,
    mu_x0, logZ_total).

    parms: dict from LinearDynamicalSystems._latent_parms
    like:  (invSigma_like, invSigmamu_like, Residual_like), each (T,)+...
    u:     (T,)+...+(control,1)
    lane_form: force the component layout on/off (default: h <= 3).
    plane_form: force the plane layout on/off (default: 3 < h <= 32 when
        the lane form is not taken); with both off, the dense form.
    """
    hdim = parms["invQ"].shape[-1]
    if lane_form is None:
        lane_form = hdim <= LANE_KALMAN_MAX_H and plane_form is not True
    if lane_form and hdim > LANE_KALMAN_MAX_H:
        raise ValueError(f"the lane form serves h <= {LANE_KALMAN_MAX_H}, got h={hdim}")
    if not lane_form and plane_form is None:
        plane_form = hdim <= PLANE_KALMAN_MAX_H
    elems, bshape, T, hdim = _build_elements(parms, x0, like, u)
    if lane_form:
        return _lane_smoother(elems, bshape, T, hdim)
    if plane_form:
        return _plane_smoother(elems, bshape, T, hdim)
    return _dense_smoother(elems, bshape, T, hdim)
