"""DMBD on batched Lorenz-63 trajectories (counterpart of
examples/lorenz_example.py, reference examples/Lorenz_example.py:20-34).

    python -m pyvbmp_tpu_torch.examples.lorenz_example
"""
import numpy as np
import torch

from ..models import DynamicMarkovBlanketDiscovery
from ..simulations import Lorenz
from ..utils import rng
from ..utils.torchutils import default_device
from ._common import can_plot, numpy, out_path, smoke_mode

BATCH, ITERS = 20, 20
SMOKE_BATCH, SMOKE_ITERS, SMOKE_STEPS, SMOKE_T = 2, 2, 150, 24


def make_data(batch_num=BATCH, smoke=False, generator=None, device=None,
              dtype=torch.float32, draws=None, num_steps=None):
    """(T, batch, 3, 2) positions and velocities in ``dtype`` on ``device``;
    ``draws`` (Lorenz.integrate's arguments) replace the generator's, and
    ``num_steps`` the integration length (the simulator's 2000, SMOKE_STEPS
    in smoke mode)."""
    device = default_device(device)
    sim = Lorenz()
    if smoke:
        sim.num_steps = SMOKE_STEPS
    if num_steps:
        sim.num_steps = num_steps
    if draws is None:
        data = sim.simulate(batch_num, generator, device)
    else:
        data = sim.integrate(*(d.to(device) for d in draws))
    if smoke:
        data = data[:SMOKE_T]
    return data.to(dtype)


def build_model(generator=None, device=None, dtype=None):
    return DynamicMarkovBlanketDiscovery(
        obs_shape=(3, 2), role_dims=(1, 2, 1), hidden_dims=(2, 2, 2),
        generator=generator, dtype=dtype, device=device,
    )


def fit(model, data, iters=ITERS, verbose=True):
    model.update(data, iters=iters, latent_iters=1, lr=0.5, verbose=verbose)
    return model


def pc_scores(model, out="lorenz_pc_scores.png"):
    """Top principal-component score per latent block (s/b/z) plus assigned
    node counts over time (reference Lorenz_example.py:83-130)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    sbz = numpy(model.px.mean())[..., 0]      # (T, batch, 1, h)
    sbz = sbz.reshape(sbz.shape[0], sbz.shape[1], -1)
    h1 = model.hidden_dims[0]
    h2 = h1 + model.hidden_dims[1]
    h3 = h2 + model.hidden_dims[2]
    p = numpy(model.assignment_pr()).sum(-2)  # (T, batch, 3)

    def top_pc(x):
        x = x - x.mean((0, 1))
        c = np.einsum("tbi,tbj->ij", x, x) / (x.shape[0] * x.shape[1])
        _, v = np.linalg.eigh(c)
        sc = x @ v[:, -1]
        return sc / sc.std()

    ss = top_pc(sbz[..., :h1])
    bb = top_pc(sbz[..., h1:h2])
    zz = top_pc(sbz[..., h2:h3])

    fig, axs = plt.subplots(2, 1, sharex=True)
    axs[0].plot(zz[:, 0], "r", label="z")
    axs[0].plot(bb[:, 0], "g", label="b")
    axs[0].plot(ss[:, 0], "b", label="s")
    axs[0].set_title("Top PC Score")
    axs[0].legend()
    axs[1].plot(p[:, 0, 2], "r")
    axs[1].plot(p[:, 0, 1], "g")
    axs[1].plot(p[:, 0, 0], "b")
    axs[1].set_title("Number of Assigned Nodes")
    axs[1].set_xlabel("Time")
    plt.savefig(out)
    plt.close(fig)
    return out


def write_plots(model, smoke):
    print("wrote", pc_scores(model, out=out_path("lorenz_pc_scores.png", smoke)))
    # labeled role/dynamics structure heatmaps (reference DMBD.py:344-415)
    paths = {k: out_path(f"dmbd_lorenz_{k}.png", smoke)
             for k in ("observation", "role_transition", "A", "A_mask")}
    model.plot_observation(path=paths["observation"])
    model.plot_transition(type="obs", path=paths["role_transition"])
    model.plot_transition(type="latent", path=paths["A"])
    model.plot_transition(type="latent", use_mask=True, path=paths["A_mask"])
    print("wrote", ", ".join(paths.values()))


def main(batch_num=BATCH, iters=ITERS, device=None, smoke=None, plots=True,
         dtype=torch.float32):
    smoke = smoke_mode(smoke)
    if smoke:  # tiny-config smoke run for the test gate
        batch_num, iters = SMOKE_BATCH, SMOKE_ITERS
    device = default_device(device)
    rng.seed(0)
    data = make_data(batch_num, smoke, rng.next_generator(), device, dtype)
    print("data:", tuple(data.shape))
    model = fit(build_model(rng.next_generator(), device, dtype), data, iters)
    p = model.assignment_pr()
    print("ELBO trace:", ["%.0f" % e for e in model.ELBO_save])
    print("assignment fractions (s,b,z):", numpy(p.mean((0, 1, 2))))
    if plots and can_plot():
        write_plots(model, smoke)
    return model


if __name__ == "__main__":
    main()
