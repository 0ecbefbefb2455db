"""The NLDS family: builds the program's recurrent switching linear dynamical
system for a configuration, puts the benchmark's starting state into it,
drives its sweeps, reads its state back, and runs the plain reference from
the same state.

The program's entry point is ``NonLinearDynamicalSystems.update(y, iters=1,
lr=...)``, as its example fits; every option of the program stays at its
default.  The family measures q(s) by the logsemiring scan pair over
per-time elements: ``build`` first runs one sweep of a tiny model and, where
the program's NLDS took q(s) another way (the scan's counters did not
move), exits at once.
"""
from __future__ import annotations

import torch

from cardbench.reference import nlds as ref

# the parameter posteriors and q(s): all a sweep reads
STATE = ("x0_mu", "x0_lambda", "x0_invU", "x0_nu", "A_mu", "A_invV", "A_invU", "A_nu",
         "B_mu", "B_invV", "B_invU", "B_nu", "T_mu", "T_invSigma", "T_invSigmamu", "T_a", "T_b",
         "pi0", "p")
# leaves compared after each checked sweep: the reference's names
LEAVES = STATE + ("px_mu",)


def served_dtype(cfg):
    """The configuration's dtype, the one the program is served in."""
    return getattr(torch, cfg["dtype"])


def make_inputs(cfg, traffic, seed, device):
    """The run's data (in the configuration's dtype) and starting state,
    both drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    data = cfg["data"]
    if data["simulator"] != "nascar":
        raise ValueError(f"unknown simulator {data['simulator']!r}")
    _, _, n = ref.dims(cfg)
    y, _ = ref.simulate(traffic["batch"], traffic["T"], n, gen, device, **data["parameters"])
    dt = served_dtype(cfg)
    return dict(y=y.to(dt), state=ref.draws(cfg, traffic, gen, dt))


def shapes(cfg, traffic):
    """The scans one sweep runs, as (T, size, lanes) by kernel group: the
    discrete chain and the latent chain of every trajectory, each one
    forward and one backward scan."""
    K, h, _ = ref.dims(cfg)
    T, B = traffic["T"], traffic["batch"]
    return {"logsemiring_scan": (T, K, B), "kalman_lane_scan": (T, h, B)}


def takes_the_scan(cfg, device, dtype):
    """Whether the program's NLDS takes q(s) through the logsemiring scan
    pair on ``device`` in ``dtype``: one sweep of a model of the
    configuration's widths on 3 steps of 2 trajectories, read off the scan's
    counters (``pyvbmp_tpu_torch/ops/scan.py:Scan``, kernel or plain, one
    pass or folded)."""
    from pyvbmp_tpu_torch.models import NonLinearDynamicalSystems
    from pyvbmp_tpu_torch.ops import scan

    def count():
        s = scan.LOGSEMIRING
        return s.launches + s.plain_calls + s.folded.launches + s.folded.plain_calls

    model = NonLinearDynamicalSystems(
        tuple(cfg["obs_shape"]), cfg["hidden_dim"], cfg["mixture_dim"],
        generator=torch.Generator().manual_seed(0), dtype=dtype, device=device)
    before = count()
    model.update(torch.zeros(3, 2, cfg["obs_shape"][-1], dtype=dtype, device=device), iters=1)
    return count() > before


def build(cfg, inputs, device, dtype=None):
    """The program's model on ``device`` in ``dtype`` (by default the
    configuration's), holding the starting state and its q(s).  Exits where
    the program's NLDS does not take q(s) through the logsemiring scan
    (``takes_the_scan``)."""
    from pyvbmp_tpu_torch.models import NonLinearDynamicalSystems
    from pyvbmp_tpu_torch.utils.torchutils import replace

    dtype = dtype or served_dtype(cfg)
    if not takes_the_scan(cfg, device, dtype):
        raise SystemExit("cardbench: this program's NLDS does not take q(s) through the "
                         "logsemiring scan, the route the nlds family measures")
    model = NonLinearDynamicalSystems(
        tuple(cfg["obs_shape"]), cfg["hidden_dim"], cfg["mixture_dim"],
        dtype=dtype, device=device)
    s = {k: v.to(device, dtype) for k, v in inputs["state"].items()}
    model.x0 = replace(model.x0, mu=s["x0_mu"].reshape(model.x0.mu.shape))
    model.A = replace(model.A, mu=s["A_mu"].reshape(model.A.mu.shape))
    model.B = replace(model.B, mu=s["B_mu"].reshape(model.B.mu.shape))
    beta = model.T.beta
    shape = beta.mu.shape
    model.T.beta = replace(
        beta, mu=s["T_mu"].reshape(shape), invSigmamu=s["T_invSigmamu"].reshape(shape),
        alpha=replace(beta.alpha, alpha=s["T_a"].reshape(shape), beta=s["T_b"].reshape(shape)))
    model.pi0 = replace(model.pi0, alpha=s["pi0"].reshape(model.pi0.alpha.shape))
    model.p = s["p"]
    return model


def sweep(model, inputs, traffic):
    """One sweep through the program's entry point; returns its ELBO, which
    the entry point has already brought to the host."""
    model.update(inputs["y"], iters=1, lr=traffic["lr"])
    return model.ELBO_save[-1]


def _leaves(model):
    x0, A, B, beta = model.x0, model.A, model.B, model.T.beta
    T, b = model.p.shape[:2]
    return dict(
        x0_mu=x0.mu, x0_lambda=x0.lambda_mu, x0_invU=x0.invU.invU, x0_nu=x0.invU.nu,
        A_mu=A.mu, A_invV=A.invV, A_invU=A.invU.invU, A_nu=A.invU.nu,
        B_mu=B.mu, B_invV=B.invV, B_invU=B.invU.invU, B_nu=B.invU.nu,
        T_mu=beta.mu[..., 0], T_invSigma=beta.invSigma, T_invSigmamu=beta.invSigmamu[..., 0],
        T_a=beta.alpha.alpha[..., 0], T_b=beta.alpha.beta[..., 0], pi0=model.pi0.alpha,
        p=model.p, px_mu=None if model.px is None else model.px.mu.reshape(T, b, -1))


def snapshot(model):
    """The model's state after a sweep, by the reference's leaf names, in
    float64 on the host."""
    return {k: v.detach().to("cpu", torch.float64).reshape(-1) for k, v in _leaves(model).items()}


def state(model):
    """The whole state a sweep starts from, by the reference's names, in
    float64 on the host: the parameter posteriors and q(s) (the column
    covariances and the weights' covariance the reference works out again
    from their precisions)."""
    leaves = _leaves(model)
    return {k: leaves[k].detach().to("cpu", torch.float64) for k in STATE}


def _out(new):
    return {k: new[k].detach().to("cpu", torch.float64).reshape(-1) for k in LEAVES}


def reference_from(cfg, inputs, traffic, st, dtype=torch.float64):
    """[(ELBO, leaves)] of one sweep of the plain reference from the state
    ``st`` (``state``) on the run's data, in ``dtype`` on the data's device.
    A q(s) whose shape is not the data's raises ValueError."""
    y = inputs["y"].to(dtype)
    if tuple(st["p"].shape[:2]) != tuple(y.shape[:2]):
        raise ValueError(f"the state's q(s) has shape {tuple(st['p'].shape)}, "
                         f"the data {tuple(y.shape)}")
    s = {k: v.to(y.device, dtype) for k, v in st.items()}
    new, elbo = ref.sweep(s, y, ref.priors(cfg, dtype, y.device), traffic["lr"])
    return [(float(elbo), _out(new))]


def reference(cfg, inputs, traffic, sweeps, dtype=torch.float64):
    """[(ELBO, leaves)] of the plain reference over ``sweeps`` sweeps from
    the run's starting state on the run's data, computed in ``dtype`` on
    the data's device."""
    y = inputs["y"].to(dtype)
    return [(elbo, _out(st))
            for elbo, st in ref.run(cfg, inputs["state"], y, traffic["lr"], sweeps)]


def start(cfg, inputs):
    """The starting parameters by leaf name, in float64 on the host; q(s)
    and the latent means, which a sweep makes anew, are absent."""
    st = ref.start(cfg, inputs["state"], torch.float64, "cpu")
    return {k: v.reshape(-1) for k, v in st.items() if k in LEAVES and k != "p"}


def observables(inputs):
    """The number of observables in the run's data: T x batch x n."""
    return inputs["y"].numel()


def flops_per_sweep(cfg, traffic, device="cpu"):
    """The matrix-product operations of one sweep of the plain reference at
    the traffic's shapes, counted after a first sweep as
    ``cardbench/count_flops.py`` counts DMBD's (``torch.utils.flop_counter``:
    2 m n k a product); stored as the cell's ``flops_per_sweep``."""
    from torch.utils.flop_counter import FlopCounterMode

    inputs = make_inputs(cfg, traffic, 0, device)
    y = inputs["y"]
    pr = ref.priors(cfg, y.dtype, y.device)
    st, _ = ref.sweep(ref.start(cfg, inputs["state"], y.dtype, y.device), y, pr, traffic["lr"])
    with FlopCounterMode(display=False) as fc:
        ref.sweep(st, y, pr, traffic["lr"])
    return fc.get_total_flops()
