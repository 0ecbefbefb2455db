"""Rank-side code for tests/test_torch_seq_parallel.py and
tests/test_torch_mesh_parallel.py.  It holds no tests, so pytest collects
nothing from it, and it imports only torch, numpy and the port: the spawned
ranks import this module, and a test module that imports jax would pull JAX
into every rank.

``spawn(world, workdir, jobs)`` (or ``start``, then ``join``) starts
``world`` processes on gloo (the
rendezvous a file in ``workdir``, so that test processes running at once do
not compete for ports), each of which builds the meshes of ``_meshes``, runs
every job of ``jobs`` (name -> (function of ``JOBS``, keyword arguments))
and saves its results as a numpy file; it returns each rank's results.
Every job resets the meshes' counts first and returns the elements its
collectives moved, by tag."""
import dataclasses
import datetime
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def _t(x):
    if isinstance(x, np.ndarray):
        return torch.tensor(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_t(v) for v in x)
    return x


def _meshes(world):
    """Every rank builds the same meshes in the same order."""
    from pyvbmp_tpu_torch.parallel import Mesh, make_mesh

    out = {"seq": make_mesh(world, "seq"), "data": make_mesh(world, "data")}
    if world == 4:
        out["seq_data"] = Mesh(np.arange(4).reshape(2, 2), ("seq", "data"))
        out["data_model"] = Mesh(np.arange(4).reshape(2, 2), ("data", "model"))
    if world in (2, 4):
        out["model"] = Mesh(np.arange(world).reshape(1, world), ("data", "model"))
    return out


def _counts(meshes):
    tags = ("scan", "halo", "reduce", "gather", "replicate", "systems", "check")
    return {t: sum(m.elements(t) for m in meshes.values()) for t in tags}


# -- jobs: each returns a dict of numpy values -------------------------------------
def job_fb(meshes, mesh, trans, init, obs, ptemp=1.0, driven=False, batch_axis="auto",
           ptemp_tensor=False):
    """A time-sharded forward-backward (driven or not) on the inputs."""
    from pyvbmp_tpu_torch.parallel import seq_parallel as sp

    fn = (sp.time_sharded_driven_forward_backward if driven
          else sp.time_sharded_forward_backward)
    pt = torch.tensor(ptemp, dtype=torch.float64) if ptemp_tensor else ptemp
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = fn(_t(trans), _t(init), _t(obs), meshes[mesh], ptemp=pt,
                     batch_axis=batch_axis)
        except ValueError as e:
            return {"error": str(e), "warnings": [str(w.message) for w in caught]}
    return {"out": _np(out), "warnings": [str(w.message) for w in caught]}


def job_scan_and_shifts(meshes, x):
    """``sharded_associative_scan`` with a bare combine (addition, both
    directions), ``shift_up`` and ``shift_down`` on this rank's chunk of
    ``x`` (torch.tensor_split over the "seq" mesh): this rank's rows of
    each."""
    from pyvbmp_tpu_torch.parallel import shift_down, shift_up, sharded_associative_scan

    mesh = meshes["seq"]
    chunk = torch.tensor_split(_t(x), mesh.shape["seq"])[mesh.coords["seq"]]
    return {
        "prefix": _np(sharded_associative_scan(torch.add, chunk, mesh, "seq")),
        "suffix": _np(sharded_associative_scan(torch.add, chunk, mesh, "seq", reverse=True)),
        "up": _np(shift_up(chunk, mesh, "seq", fill=7.0)),
        "down": _np(shift_down(chunk, mesh, "seq", torch.full(x.shape[1:], -1.0))),
    }


def job_kalman(meshes, mesh, state, y):
    """The time-sharded Kalman smoother on an LDS's own parameters and
    messages (the LDS from ``state``, data ``y``)."""
    from pyvbmp_tpu_torch.parallel import time_sharded_kalman_smoother
    from pyvbmp_tpu_torch.utils.convert import lds_from_state

    lds = lds_from_state(state, device="cpu", dtype=torch.float64)
    yv, uv, rv = lds.reshape_inputs(_t(y))
    parms = lds._latent_parms(lds.A)
    like = lds.log_likelihood_function(lds.obs_model, yv, rv)
    out = time_sharded_kalman_smoother(parms, lds.x0, like, uv, meshes[mesh])
    return {"out": _np(out)}


def _build(kind, state, time_mesh):
    from pyvbmp_tpu_torch.utils import convert

    kw = {} if time_mesh is None else dict(time_mesh=time_mesh)
    return getattr(convert, f"{kind}_from_state")(state, device="cpu", dtype=torch.float64,
                                                   **kw)


def _summary(kind, m):
    """What a fit is compared on, besides its ELBO trajectory."""
    if kind == "hmm":
        return {"alpha": m.transition.alpha, "p": m.p}
    if kind == "dhmm":
        return {"p": m.p}
    if kind == "lds":
        return {"A_mu": m.A.mu, "px_mu": m.px.mu}
    if kind == "mixlds":
        return {"A_mu": m.lds.A.mu, "p": m.p}
    if kind == "dmbd":
        return {"A_mu": m.A.mu, "p": m.obs_model.p, "px_mu": m.px.mu}
    if kind in ("tensor_hmm", "nlds"):
        return {"params": _params(kind, m), "p": m.p}
    if kind in ("bfa", "cbt"):
        return {"params": _params(kind, m)}
    return {"mu": m.dist.mu if hasattr(m.dist, "mu") else m.dist.alpha,
            "pi": m.pi.alpha}  # a mixture


def _fit(m, kind, data, sweeps):
    if kind == "dhmm":
        m.raw_update(*_t(data), iters=sweeps)
    else:
        m.update(*_t(data), iters=sweeps)


def job_chunk_fit(meshes, kind, state, data, sweeps, mesh="seq"):
    """A fit with ``time_mesh`` = meshes[mesh]: its ELBOs, its ``ELBO()``
    (where the model's reads its state), this rank's per-time state and
    chunk, the state exporter's refusal while the model holds the chunk,
    the whole posterior that ``gather_posterior`` makes after it (with the
    collectives of the sweep and of the gathering counted apart), every
    parameter node's state, and one more sweep of a model built with the
    mesh from the exported whole state (``resumed``)."""
    from pyvbmp_tpu_torch.parallel import gather_posterior
    from pyvbmp_tpu_torch.utils import convert

    m = _build(kind, state, meshes[mesh])
    _fit(m, kind, data, sweeps)
    sweep_counts = _counts(meshes)
    chunk = m.time_chunk
    local = _chunk_state(m)
    export = getattr(convert, f"{kind}_state")
    try:
        export(m)
        refused = ""
    except ValueError as e:
        refused = str(e)
    whole = {k: (_px(v) if not isinstance(v, torch.Tensor) else v)
             for k, v in gather_posterior(m).items()}
    resumed = _build(kind, export(m), meshes[mesh])
    _fit(resumed, kind, data, 1)
    gather_posterior(resumed)
    ba = chunk.batch_axis
    return {"elbo": np.asarray(m.ELBO_save), "elbo_now": _elbo_now(m),
            "params": _params(kind, m), "local": _np(local), "whole": _np(whole),
            "refused": refused, "bounds": (chunk.start, chunk.end), "batch_axis": ba,
            "batch_parts": 1 if ba is None else chunk.mesh.shape[ba],
            "batch_coord": 0 if ba is None else chunk.mesh.coords[ba],
            "sweep_counts": sweep_counts,
            "resumed": {"elbo": resumed.ELBO_save[-1], "params": _params(kind, resumed)}}


def _elbo_now(m):
    """The model's ``ELBO()``, or None where it has none."""
    return None if not hasattr(m, "ELBO") else np.asarray(_np(m.ELBO()), np.float64)


def whole_estep(m, kind, data):
    """The model's E-step that runs outside ``update`` (HMM
    ``update_states``, LDS ``update_latents``, dHMM ``raw_update_states``)
    on the whole data."""
    if kind == "hmm":
        m.update_states(_t(data[0]))
    elif kind == "lds":
        m.update_latents(*m.reshape_inputs(_t(data[0])))
    else:
        U, Y = _t(data)
        m.raw_update_states(U[..., None, :], Y[..., None, :])


def job_whole_estep(meshes, kind, state, data, sweeps):
    """A time-sharded fit, then ``whole_estep``: the model's per-time state
    as ``gather_posterior`` returns it, whether the model still held a
    chunk, and the elements that the gathering moved."""
    from pyvbmp_tpu_torch.parallel import gather_posterior

    m = _build(kind, state, meshes["seq"])
    _fit(m, kind, data, sweeps)
    whole_estep(m, kind, data)
    held_chunk = m.time_chunk is not None
    for mesh in meshes.values():
        mesh.reset_counts()
    whole = {k: (_px(v) if not isinstance(v, torch.Tensor) else v)
             for k, v in gather_posterior(m).items()}
    return {"whole": _np(whole), "held_chunk": held_chunk,
            "gathered": _counts(meshes)["gather"]}


def _px(px):
    return {f: getattr(px, f) for f in ("mu", "Sigma", "invSigmamu", "invSigma")}


def _chunk_state(m):
    """The model's per-time state as its ``CHUNK_STATE`` names it."""
    out = {}
    for path in m.CHUNK_STATE:
        x = m
        for name in path.split("."):
            x = getattr(x, name)
        out[name] = x if isinstance(x, torch.Tensor) else _px(x)
    return out


def _params(kind, m):
    """Every parameter node's state (the model's ``*_state`` without its
    config and posteriors)."""
    from pyvbmp_tpu_torch.utils import convert

    state = getattr(convert, f"{kind}_state")(m)
    return {k: v for k, v in state.items() if k not in ("config", "px", "p", "expand_to_batch",
                                                         "obs_config", "kind", "ptemp",
                                                         "obs_shapes")}


def job_data_parallel(meshes, kind, state, data, sweeps, mesh="data", batch_axis=None,
                      time_mesh=None):
    """``data_parallel_update`` of a model from ``state`` over meshes[mesh]
    (with ``time_mesh`` = meshes[time_mesh] too, when given).  NLDS's q(s)
    (``p_block``) is returned: this rank's block."""
    from pyvbmp_tpu_torch.parallel import data_parallel_update

    m = _build(kind, state, None if time_mesh is None else meshes[time_mesh])
    data_parallel_update(m, _t(data[0]), mesh=meshes[mesh], iters=sweeps,
                         batch_axis=batch_axis)
    s = _summary(kind, m)
    p_block = s.pop("p", None) if kind == "nlds" else None
    s.pop("p", None), s.pop("px_mu", None)  # per-sample state stays this rank's block
    out = _np(s)
    if hasattr(m, "ELBO_save"):
        out["elbo"] = np.asarray(m.ELBO_save)
    if p_block is not None:
        out["p_block"] = _np(p_block)
    return out


def job_systems(meshes, state, data, sweeps, mesh):
    """``data_parallel_update`` of a MixLDS from ``state`` over
    meshes[mesh], a ("data", "model") mesh that cuts its systems: its ELBOs
    and parameter nodes, the collectives of the call (``sweep_counts``),
    the state exporter's refusal while lds.px holds this rank's systems,
    and the px that ``gather_posterior`` makes whole over the systems
    (with what the gathering moved)."""
    from pyvbmp_tpu_torch.parallel import data_parallel_update, gather_posterior
    from pyvbmp_tpu_torch.utils import convert

    m = _build("mixlds", state, None)
    data_parallel_update(m, _t(data[0]), mesh=meshes[mesh], iters=sweeps)
    sweep_counts = _counts(meshes)
    local = m.lds.px.mu
    try:
        convert.mixlds_state(m)
        refused = ""
    except ValueError as e:
        refused = str(e)
    for mm in meshes.values():
        mm.reset_counts()
    whole = gather_posterior(m)
    mesh = meshes[mesh]
    return {"elbo": np.asarray(m.ELBO_save), "params": _params("mixlds", m),
            "p": _np(m.p), "local_shape": tuple(local.shape), "refused": refused,
            "px": _np(_px(whole["px"])), "sweep_counts": sweep_counts,
            "gathered": _counts(meshes)["gather"], "batch_shape": m.lds.batch_shape,
            "data_parts": mesh.shape["data"], "data_coord": mesh.coords["data"],
            "model_parts": mesh.shape["model"], "model_coord": mesh.coords["model"]}


def job_refusals(meshes, lds_state, mix_state, data):
    """What ``data_parallel_update`` raises where a "model" axis cannot cut
    the systems: another model (an LDS), a MixLDS with a ``time_mesh``, and
    more ranks on the axis than systems; error type and message each."""
    from pyvbmp_tpu_torch.parallel import data_parallel_update

    y = _t(data)
    out = {}
    for name, build, mesh in (
            ("lds", lambda: _build("lds", lds_state, None), "model"),
            ("time_mesh", lambda: _build("mixlds", mix_state, meshes["seq"]), "data_model"),
            ("too many ranks", lambda: _build("mixlds", mix_state, None), "model")):
        try:
            data_parallel_update(build(), y, mesh=meshes[mesh])
            out[name] = ("", "")
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


class LocalSums:
    """A model whose sweep sums over its block of the batch on its own: its
    ELBO is the sum of the data it was given."""

    def __init__(self):
        self.ELBO_save = []

    def update(self, X, iters=1, lr=1.0):
        for _ in range(iters):
            self.ELBO_save.append(float(X.sum()))


def job_check(meshes, data, sweeps):
    """``data_parallel_update`` of a ``LocalSums``: the error it raises,
    type and message."""
    from pyvbmp_tpu_torch.parallel import data_parallel_update

    try:
        data_parallel_update(LocalSums(), _t(data), mesh=meshes["data"], iters=sweeps)
    except RuntimeError as e:
        return {"error": ("RuntimeError", str(e))}
    return {"error": ("", "")}


def job_refused(meshes, data):
    """What ``data_parallel_update`` raises for each model it refuses: the
    ARHMMs, whose observations are a tuple, and a Mixture over a
    MultivariateNormal, which sums on its own (class -> (error type,
    message))."""
    from pyvbmp_tpu_torch import models
    from pyvbmp_tpu_torch.dists import Mixture, MultivariateNormal
    from pyvbmp_tpu_torch.parallel import data_parallel_update

    kw = dict(generator=torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu")
    X = _t(data)[..., None, :, None]  # (T, batch, 1, 2, 1)
    cases = {
        "ARHMM": (models.ARHMM(3, 2, 2, **kw), (X, X)),
        "ARHMM_prXY": (models.ARHMM_prXY(3, 2, 2, **kw), (X, X)),
        "ARHMM_prXRY": (models.ARHMM_prXRY(3, 2, 2, 1, **kw), (X, X[..., :1, :], X)),
        "Mixture over MultivariateNormal": (
            Mixture(MultivariateNormal(mu=torch.tensor(np.random.RandomState(1).randn(3, 2)),
                                       Sigma=torch.eye(2, dtype=torch.float64).expand(3, 2, 2)),
                    (3,)), _t(data).reshape(-1, 2)),
    }
    out = {}
    for name, (m, y) in cases.items():
        try:
            data_parallel_update(m, y, mesh=meshes["data"], batch_axis=0 if "Mixture" in name
                                 else None)
            out[name] = ("", "")
        except (NotImplementedError, RuntimeError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def job_replicate(meshes, state):
    """``replicate`` of a DMBD whose ranks started from different states:
    every rank ends with rank 0's."""
    from pyvbmp_tpu_torch.parallel import replicate
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state

    m = dmbd_from_state(state, device="cpu", dtype=torch.float64)
    m.A = dataclasses.replace(m.A, mu=m.A.mu + dist.get_rank())
    replicate(meshes["data"], m)
    return {"A_mu": _np(m.A.mu), "x0_mu": _np(m.x0.mu)}


def job_shard_shapes(meshes, shapes):
    """This rank's block of zeros of each (shape, batch_axis)."""
    from pyvbmp_tpu_torch.parallel import shard_batch

    return {"shapes": [tuple(shard_batch(meshes["data"], torch.zeros(sh), ax).shape)
                       for sh, ax in shapes]}


def state_pairs(got, want, path=""):
    """(path, got leaf, want leaf) over the reference's leaves."""
    if isinstance(want, dict):
        for k, v in want.items():
            assert k in got, (path, k)
            yield from state_pairs(got[k], v, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, v) in enumerate(zip(got, want)):
            yield from state_pairs(g, v, f"{path}[{i}]")
    elif want is not None:
        yield path, np.asarray(got), np.asarray(want)


def leaf_dev(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == bool or not want.size:
        return 0.0 if np.array_equal(got, want) else np.inf
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


JOBS = {name[4:]: fn for name, fn in globals().items() if name.startswith("job_")}


def _main(rank, world, workdir):
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    # a rank that fails stops the others at their next collective, not after
    # gloo's default half hour
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        jobs = np.load(Path(workdir) / "jobs.npy", allow_pickle=True).item()
        meshes = _meshes(world)
        for key, (fn, kw) in jobs.items():
            for m in meshes.values():
                m.reset_counts()
            try:
                res = JOBS[fn](meshes, **kw)
            except Exception:
                res = {"traceback": traceback.format_exc()}
            res["counts"] = _counts(meshes)
            out[key] = res
    finally:
        np.save(Path(workdir) / f"out{rank}.npy", out, allow_pickle=True)
        dist.destroy_process_group()


def start(world, workdir, jobs):
    """Start ``jobs`` on ``world`` gloo ranks without waiting for them;
    ``join`` waits and returns their results."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    np.save(workdir / "jobs.npy", jobs, allow_pickle=True)
    ctx = mp.start_processes(_main, args=(world, str(workdir)), nprocs=world, join=False,
                             start_method="spawn")
    return ctx, world, workdir


def join(started, timeout=600):
    """Each rank's results (a list by rank of dicts: job name -> results);
    ranks still running after ``timeout`` seconds are ended and the wait
    fails."""
    ctx, world, workdir = started
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"{world} ranks still running after {timeout} s")
    return [np.load(workdir / f"out{r}.npy", allow_pickle=True).item() for r in range(world)]


def spawn(world, workdir, jobs):
    """Run ``jobs`` on ``world`` gloo ranks and return their results."""
    return join(start(world, workdir, jobs))
