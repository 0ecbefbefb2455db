"""The DMBD family: builds the program's model for a configuration, puts the
benchmark's starting state into it, drives its sweeps, reads its state back,
and runs the plain reference from the same state.

The program's entry point is ``DynamicMarkovBlanketDiscovery.update(y,
iters=1, latent_iters=1, lr=...)``, as its examples fit; every other option
of the program stays at its default, but for ``parallel_scan=True``, the
scan smoothers the examples use.
"""
from __future__ import annotations

import torch

from cardbench.reference import dmbd as ref
from cardbench.reference import simulations

# leaves compared after each checked sweep: the reference's names
LEAVES = ("x0_mu", "x0_lambda", "x0_invU", "x0_nu", "A_mu", "A_invV", "A_alpha", "A_beta",
          "B_mu", "B_invV", "B_invU", "B_nu", "trans", "init", "p", "px_mu")


def make_data(cfg, traffic, generator):
    """(T, batch, O, n) float64 trajectories on the generator's device."""
    data, dev = cfg["data"], generator.device
    par = data.get("parameters", {})
    if data["simulator"] == "lorenz":
        # T rows kept every keep_every of the smoothed rows
        steps = traffic["T"] * par["keep_every"] + par["smoothing_steps"] + 1
        y = simulations.lorenz(traffic["batch"], steps, generator, dev, **par)
    elif data["simulator"] == "flocking":
        y = simulations.flocking(traffic["batch"], cfg["obs_shape"][0], traffic["T"],
                                 generator, dev, **par)
    else:
        raise ValueError(f"unknown simulator {data['simulator']!r}")
    if y.shape[0] != traffic["T"]:
        raise ValueError(f"the simulator gave {y.shape[0]} steps, the traffic asks {traffic['T']}")
    return y


def served_dtype(cfg):
    """The configuration's dtype, the one the program is served in."""
    return getattr(torch, cfg["dtype"])


def make_inputs(cfg, traffic, seed, device):
    """The run's data (in the configuration's dtype) and starting state,
    both drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = served_dtype(cfg)
    y = make_data(cfg, traffic, gen).to(dt)
    return dict(y=y, state=ref.draws(cfg, gen, dt))


def shapes(cfg, traffic):
    """The scans one sweep runs, as (T, size, lanes) by kernel group: the
    role chain of every observable and the latent chain of every
    trajectory, each one forward and one backward scan."""
    K, H, _, O = ref.dims(cfg)
    T, B = traffic["T"], traffic["batch"]
    return {"logsemiring_scan": (T, K, B * O), "kalman_plane_scan": (T, H, B)}


def build(cfg, inputs, device, dtype=None):
    """The program's model on ``device`` in ``dtype`` (by default the
    configuration's), holding the starting state."""
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
    from pyvbmp_tpu_torch.utils.torchutils import replace

    dtype = dtype or served_dtype(cfg)
    model = DynamicMarkovBlanketDiscovery(
        tuple(cfg["obs_shape"]), tuple(cfg["role_dims"]), tuple(cfg["hidden_dims"]),
        number_of_objects=cfg["number_of_objects"], parallel_scan=True,
        dtype=dtype, device=device)
    s = {k: v.to(dtype) for k, v in inputs["state"].items()}
    om = model.obs_model
    A = model.A
    g = A.invU.gamma
    model.A = replace(A, mu=s["A_mu"].reshape(A.mu.shape),
                      invU=replace(A.invU, gamma=replace(g, alpha=s["A_alpha"].reshape(g.alpha.shape),
                                                          beta=s["A_beta"].reshape(g.beta.shape))))
    B = om.obs_dist
    om.obs_dist = replace(B, mu=s["B_mu"].reshape(B.mu.shape))
    om.transition = replace(om.transition, alpha=s["trans"].reshape(om.transition.alpha.shape))
    om.initial = replace(om.initial, alpha=s["init"].reshape(om.initial.alpha.shape))
    return model


def sweep(model, inputs, traffic):
    """One sweep through the program's entry point; returns its ELBO, which
    the entry point has already brought to the host."""
    model.update(inputs["y"], iters=1, latent_iters=1, lr=traffic["lr"])
    return model.ELBO_last


def snapshot(model):
    """The model's state after a sweep, by the reference's leaf names, in
    float64 on the host."""
    om, B, A = model.obs_model, model.obs_model.obs_dist, model.A
    T, Bn = model.px.mu.shape[:2]
    leaves = dict(
        x0_mu=model.x0.mu, x0_lambda=model.x0.lambda_mu, x0_invU=model.x0.invU.invU,
        x0_nu=model.x0.invU.nu, A_mu=A.mu, A_invV=A.invV, A_alpha=A.invU.gamma.alpha,
        A_beta=A.invU.gamma.beta, B_mu=B.mu, B_invV=B.invV, B_invU=B.invU.invU,
        B_nu=B.invU.nu, trans=om.transition.alpha, init=om.initial.alpha, p=om.p,
        px_mu=model.px.mu.reshape(T, Bn, -1))
    return {k: v.detach().to("cpu", torch.float64).reshape(-1) for k, v in leaves.items()}


def state(model):
    """The whole state a sweep starts from, by the reference's names, in
    float64 on the host: the posteriors and the latent posterior of the
    last sweep (the column covariances ``A_V`` and ``B_V`` the reference
    works out again from their precisions, ``reference_from``)."""
    om, B, A = model.obs_model, model.obs_model.obs_dist, model.A
    T, Bn = model.px.mu.shape[:2]
    H = A.mu.shape[-2]
    leaves = dict(
        x0_mu=model.x0.mu.reshape(H), x0_lambda=model.x0.lambda_mu.reshape(()),
        x0_invU=model.x0.invU.invU.reshape(H, H), x0_nu=model.x0.invU.nu.reshape(()),
        A_mu=A.mu.reshape(H, H + 1), A_invV=A.invV.reshape(H + 1, H + 1),
        A_alpha=A.invU.gamma.alpha.reshape(H), A_beta=A.invU.gamma.beta.reshape(H),
        B_mu=B.mu.reshape(B.mu.shape[-3:]), B_invV=B.invV.reshape(B.invV.shape[-3:]),
        B_invU=B.invU.invU.reshape(B.invU.invU.shape[-3:]), B_nu=B.invU.nu.reshape(-1),
        trans=om.transition.alpha.reshape(om.transition.alpha.shape[-2:]),
        init=om.initial.alpha.reshape(-1),
        px_mu=model.px.mu.reshape(T, Bn, H), px_Sigma=model.px.Sigma.reshape(T, Bn, H, H))
    return {k: v.detach().to("cpu", torch.float64) for k, v in leaves.items()}


def reference_from(cfg, inputs, traffic, st, dtype=torch.float64):
    """[(ELBO, leaves)] of one sweep of the plain reference from the state
    ``st`` (``state``) on the run's data, in ``dtype`` on the data's device.
    A latent posterior whose shape is not the data's raises ValueError."""
    y = inputs["y"].to(dtype)
    if tuple(st["px_mu"].shape[:2]) != tuple(y.shape[:2]):
        raise ValueError(f"the state's latent posterior has shape {tuple(st['px_mu'].shape)}, "
                         f"the data {tuple(y.shape)}")
    s = {k: v.to(y.device, dtype) for k, v in st.items()}
    # the pseudo-inverse is the inverse but for the starting emissions,
    # whose precision is 0 on the columns a role does not read (``ref.start``)
    s["A_V"], s["B_V"] = (torch.linalg.pinv(ref.sym(s[k]), hermitian=True)
                          for k in ("A_invV", "B_invV"))
    new, elbo = ref.sweep(s, y, ref.priors(cfg, dtype, y.device), traffic["lr"])
    return [(float(elbo), {k: new[k].detach().to("cpu", torch.float64).reshape(-1)
                           for k in LEAVES})]


def reference(cfg, inputs, traffic, sweeps, dtype=torch.float64):
    """[(ELBO, leaves)] of the plain reference over ``sweeps`` sweeps from
    the run's starting state on the run's data, computed in ``dtype`` on
    the data's device."""
    y = inputs["y"].to(dtype)
    out = []
    for elbo, st in ref.run(cfg, inputs["state"], y, traffic["lr"], sweeps):
        out.append((elbo, {k: st[k].detach().to("cpu", torch.float64).reshape(-1)
                           for k in LEAVES}))
    return out


def start(cfg, inputs):
    """The starting state by leaf name, in float64 on the host; the role
    marginals and latent means, which a sweep makes from nothing, are
    absent."""
    st = ref.start(cfg, inputs["state"], torch.float64, "cpu")
    return {k: v.reshape(-1) for k, v in st.items() if k in LEAVES}


def observables(inputs):
    """The number of observables in the run's data: T x batch x O."""
    return inputs["y"].shape[:3].numel()
