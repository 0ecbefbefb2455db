"""Carry a model's state across packages and devices as a nested dict of
numpy arrays.

- ``dmbd_state(model)``, ``hmm_state(model)``, ``lds_state(model)`` and
  ``mixlds_state(model)`` read the state by attribute access alone, so each takes a model of this
  package or of the JAX package ``pyvbmp_tpu`` (whose arrays it converts
  with ``np.asarray``; jax itself is never imported here);
- ``dmbd_from_state``, ``hmm_from_state``, ``lds_from_state`` and
  ``mixlds_from_state`` (state, device, dtype) build this package's model from such a dict: built on the
  CPU in float64, then moved to ``device``, which defaults to the card
  (``torchutils.default_device``: with no card and no device they raise
  before building anything).

The chain models have the same pair of functions: ``arhmm_state`` (an
ARHMM, ARHMM_prXY or ARHMM_prXRY, its class under ``kind``), ``dhmm_state``
(NormalInverseWishart observations) and ``nlds_state``, each with its
``..._from_state``; they carry ``parallel_scan``, ``ptemp`` and ``pad_X``
where the model has them, and p (an NLDS's q(s)) when it is set.

The mixtures have ``gmm_state`` (a GaussianMixtureModel, NIW or
isotropic, a PoissonMixtureModel or a GMM_vector; the component node's class
under ``kind``) and ``gmm_from_state``; the tensor-state HMMs (Tensor_HMM,
HHMM, Factorial_HMM) ``tensor_hmm_state`` and ``tensor_hmm_from_state``.
``node_state`` and ``load_state`` carry any node, fields that hold a list of
nodes included (Hierarchical_Dirichlet's and HierarchicalTransition's
``dists``).

The classifiers have the same pair of functions: ``mvn_ard_state`` (an
MVN_ard node with its Gamma, and its shapes), ``mnlr_state``,
``bouchard_state``, ``dmixlt_state`` and ``nlrm_state``, each with its
``..._from_state``.  Their dicts hold the constructor arguments under
``config`` and one entry per posterior node (``beta``; ``A`` and ``pi``;
``A`` and ``Z``).

Random initialisation cannot be shared between the packages (``jax.random``
and ``torch.Generator`` draw different numbers), so parity runs go JAX model
-> state -> port.  A DMBD's dict holds:

    config                  constructor arguments (parallel_scan and
                            batch_shape among them)
    x0                      NormalInverseWishart (with its Wishart invU)
    A                       MatrixNormalGamma (with mask and its Gamma rows)
    obs_model.transition    Dirichlet (masked entries have alpha_0 == 0)
    obs_model.initial       Dirichlet
    obs_model.transition_mask (None with unique_obs)
    obs_model.obs_dist      MatrixNormalWishart (with X_mask)
    px, p                   the last posteriors, when the model has run

A standalone HMM's (NormalInverseWishart observations) holds its config
(the observation shapes, ptemp, parallel_scan), transition and initial
(Dirichlet), transition_mask (or None), obs_dist (NormalInverseWishart) and
p when the model has run.  An LDS's dict holds its config, x0 (NormalInverseWishart), A
(MatrixNormalGamma, or MatrixNormalWishart for latent_noise="shared"),
obs_model (MatrixNormalWishart, masks included, or the MNW or MNG the caller
gave, with or without pad_X: its class and pad_X under obs_config),
expand_to_batch and px when the model has run; a MixLDS's holds its config,
the LDS nodes, pi (Dirichlet) and p when the model has run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .torchutils import default_device

_PX_FIELDS = ("mu", "Sigma", "invSigmamu", "invSigma")


def _array(x):
    if hasattr(x, "detach"):  # a torch tensor, possibly on the card
        return x.detach().cpu().numpy()
    return np.asarray(x)


def node_state(n):
    """Every array field of a node (recursing into sub-nodes and lists of
    sub-nodes); shape and flag fields are rebuilt from the config instead."""
    out = {}
    for f in dataclasses.fields(n):
        v = getattr(n, f.name)
        if v is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(v):
            out[f.name] = node_state(v)
        elif isinstance(v, list):
            out[f.name] = [node_state(x) for x in v]
        elif not isinstance(v, (bool, int, float, str, tuple)):
            out[f.name] = _array(v)
    return out


def dmbd_state(model):
    """Nested dict of numpy arrays holding a DMBD's configuration and state."""
    if getattr(model.obs_model.obs_dist, "pad_X", False):
        raise ValueError("DMBD emission with pad_X=True is not supported")
    om = model.obs_model
    state = {
        "config": dict(
            obs_shape=tuple(model.obs_shape),
            role_dims=tuple(model.role_dims),
            hidden_dims=tuple(model.hidden_dims),
            control_dim=model.control_dim - 1,
            regression_dim=model.regression_dim - 1,
            batch_shape=tuple(model.batch_shape),
            number_of_objects=model.number_of_objects,
            unique_obs=bool(model.unique_obs),
            parallel_scan=bool(model.parallel_scan),
        ),
        "x0": node_state(model.x0),
        "A": node_state(model.A),
        "obs_model": {
            "transition": node_state(om.transition),
            "initial": node_state(om.initial),
            "transition_mask": (None if om.transition_mask is None
                                else _array(om.transition_mask)),
            "obs_dist": node_state(om.obs_dist),
        },
    }
    if model.px is not None:
        state["px"] = {k: _array(getattr(model.px, k)) for k in _PX_FIELDS}
    if om.p is not None:
        state["p"] = _array(om.p)
    return state


def load_state(n, d):
    """``n`` with every field found in ``d`` replaced (float64 tensors on the
    CPU; masks keep their bool type)."""
    changes = {}
    for f in dataclasses.fields(n):
        if f.name not in d:
            continue
        cur, v = getattr(n, f.name), d[f.name]
        if dataclasses.is_dataclass(cur):
            changes[f.name] = load_state(cur, v)
        elif isinstance(cur, list):
            if len(v) != len(cur):
                raise ValueError(f"{type(n).__name__}.{f.name}: state has {len(v)} nodes, "
                                 f"model has {len(cur)}")
            changes[f.name] = [load_state(c, x) for c, x in zip(cur, v)]
        elif v is None:
            changes[f.name] = None
        elif f.name == "mask":
            changes[f.name] = np.array(v, bool)
        else:
            v = np.asarray(v)
            t = torch.tensor(v if v.dtype == bool else v.astype(np.float64))
            if cur is not None and tuple(t.shape) != tuple(cur.shape):
                raise ValueError(
                    f"{type(n).__name__}.{f.name}: state has shape {tuple(t.shape)}, "
                    f"model has {tuple(cur.shape)}"
                )
            changes[f.name] = t
    return dataclasses.replace(n, **changes)


def _load_p(model, state):
    """Set ``model.p``, the last assignments, when the state holds them."""
    if "p" in state:
        model.p = torch.tensor(np.asarray(state["p"], np.float64))


def dmbd_from_state(state, device=None, dtype=None):
    """This package's DMBD holding ``state``, on ``device`` in ``dtype``."""
    device = default_device(device)
    from ..models import DynamicMarkovBlanketDiscovery

    model = DynamicMarkovBlanketDiscovery(
        **state["config"],
        generator=torch.Generator().manual_seed(0),
        dtype=torch.float64, device="cpu",
    )
    om = model.obs_model
    model.x0 = load_state(model.x0, state["x0"])
    model.A = load_state(model.A, state["A"])
    om.transition = load_state(om.transition, state["obs_model"]["transition"])
    om.initial = load_state(om.initial, state["obs_model"]["initial"])
    mask = state["obs_model"]["transition_mask"]
    om.transition_mask = None if mask is None else torch.tensor(np.asarray(mask, bool))
    om.obs_dist = load_state(om.obs_dist, state["obs_model"]["obs_dist"])
    if "px" in state:
        from ..dists.mvn_vector_format import MultivariateNormal_vector_format

        model.px = MultivariateNormal_vector_format(
            **{k: torch.tensor(np.asarray(state["px"][k], np.float64))
               for k in _PX_FIELDS}
        )
    _load_p(om, state)
    return model.to(device, dtype)


def hmm_state(model):
    """Nested dict of numpy arrays holding a standalone HMM with
    NormalInverseWishart observations: its configuration and state."""
    obs = model.obs_dist
    mask = model.transition_mask
    state = {
        "config": dict(
            event_shape=tuple(obs.event_shape),
            batch_shape=tuple(obs.batch_shape),
            ptemp=float(model.ptemp),
            parallel_scan=bool(model.parallel_scan),
        ),
        "transition": node_state(model.transition),
        "initial": node_state(model.initial),
        "transition_mask": None if mask is None else _array(mask),
        "obs_dist": node_state(obs),
    }
    if model.p is not None:
        state["p"] = _array(model.p)
    return state


def hmm_from_state(state, device=None, dtype=None):
    """This package's HMM (NormalInverseWishart observations) holding
    ``state``, on ``device`` in ``dtype``."""
    device = default_device(device)
    from ..dists import NormalInverseWishart
    from ..models import HMM

    cfg = state["config"]
    g = torch.Generator().manual_seed(0)
    obs = NormalInverseWishart.create(cfg["event_shape"], cfg["batch_shape"], generator=g,
                                      dtype=torch.float64, device="cpu")
    mask = state["transition_mask"]
    model = HMM(
        load_state(obs, state["obs_dist"]),
        transition_mask=None if mask is None else torch.tensor(np.asarray(mask)),
        ptemp=cfg["ptemp"], parallel_scan=cfg["parallel_scan"],
        generator=g, dtype=torch.float64, device="cpu",
    )
    model.transition = load_state(model.transition, state["transition"])
    model.initial = load_state(model.initial, state["initial"])
    _load_p(model, state)
    return model.to(device, dtype)


def _lds_nodes(lds):
    if getattr(lds, "time_mesh", None) is not None:
        raise ValueError("time_mesh is not ported")
    return {
        "x0": node_state(lds.x0),
        "A": node_state(lds.A),
        "obs_model": node_state(lds.obs_model),
    }


def _load_lds_nodes(lds, state):
    lds.x0 = load_state(lds.x0, state["x0"])
    lds.A = load_state(lds.A, state["A"])
    lds.obs_model = load_state(lds.obs_model, state["obs_model"])


def lds_state(model):
    """Nested dict of numpy arrays holding an LDS's configuration and state."""
    state = {
        "config": dict(
            obs_shape=tuple(model.obs_shape),
            hidden_dim=model.hidden_dim,
            control_dim=model.control_dim - 1,
            regression_dim=model.regression_dim - 1,
            latent_noise=model.latent_noise,
            batch_shape=tuple(model.batch_shape),
            cross_cov_compat=bool(model.cross_cov_compat),
            parallel_scan=bool(model.parallel_scan),
        ),
        "expand_to_batch": bool(model.expand_to_batch),
        "obs_config": _obs_config(model.obs_model),
        **_lds_nodes(model),
    }
    if model.px is not None:
        state["px"] = {k: _array(getattr(model.px, k)) for k in _PX_FIELDS}
    return state


_DEFAULT_OBS = dict(kind="MatrixNormalWishart", pad_X=False)


def _obs_config(om):
    """The class and pad_X of an LDS's observation model (and MNG's
    uniform_precision)."""
    out = dict(kind=type(om).__name__, pad_X=bool(om.pad_X))
    if hasattr(om, "uniform_precision"):
        out["uniform_precision"] = bool(om.uniform_precision)
    return out


def _obs_model(state, generator):
    """The observation model an LDS's state was fitted with, built on the
    CPU in float64, or None for the constructor's own."""
    oc = state.get("obs_config", _DEFAULT_OBS)
    if oc == _DEFAULT_OBS:
        return None
    from .. import transforms

    c = state["config"]
    width = c["hidden_dim"] + c["regression_dim"] + 1 - int(oc["pad_X"])
    kw = {k: v for k, v in oc.items() if k != "kind"}
    return getattr(transforms, oc["kind"]).create(
        tuple(c["obs_shape"]) + (width,), tuple(c["batch_shape"]), **kw,
        generator=generator, dtype=torch.float64, device="cpu")


def lds_from_state(state, device=None, dtype=None):
    """This package's LDS holding ``state``, on ``device`` in ``dtype``."""
    device = default_device(device)
    from ..dists.mvn_vector_format import MultivariateNormal_vector_format
    from ..models import LinearDynamicalSystems

    g = torch.Generator().manual_seed(0)
    model = LinearDynamicalSystems(
        **state["config"], obs_model=_obs_model(state, g),
        generator=g, dtype=torch.float64, device="cpu",
    )
    model.expand_to_batch = state["expand_to_batch"]
    _load_lds_nodes(model, state)
    if "px" in state:
        model.px = MultivariateNormal_vector_format(
            **{k: torch.tensor(np.asarray(state["px"][k], np.float64))
               for k in _PX_FIELDS}
        )
    return model.to(device, dtype)


def mixlds_state(model):
    """Nested dict of numpy arrays holding a MixLDS's configuration and
    state."""
    lds = model.lds
    state = {
        "config": dict(
            num_systems=model.num_systems,
            obs_shape=tuple(lds.obs_shape),
            hidden_dim=lds.hidden_dim,
            control_dim=lds.control_dim - 1,
            regression_dim=lds.regression_dim - 1,
            parallel_scan=bool(lds.parallel_scan),
        ),
        "lds": _lds_nodes(lds),
        "pi": node_state(model.pi),
    }
    if getattr(model, "p", None) is not None:
        state["p"] = _array(model.p)
    return state


def mixlds_from_state(state, device=None, dtype=None):
    """This package's MixLDS holding ``state``, on ``device`` in ``dtype``."""
    device = default_device(device)
    from ..models import MixtureofLinearDynamicalSystems

    model = MixtureofLinearDynamicalSystems(
        **state["config"],
        generator=torch.Generator().manual_seed(0),
        dtype=torch.float64, device="cpu",
    )
    _load_lds_nodes(model.lds, state["lds"])
    model.pi = load_state(model.pi, state["pi"])
    _load_p(model, state)
    return model.to(device, dtype)


# -- classifiers ---------------------------------------------------------------
def mvn_ard_state(n):
    """Nested dict of numpy arrays holding an MVN_ard node and its shapes."""
    return {
        "config": dict(event_shape=tuple(n.event_shape),
                       batch_shape=tuple(n.batch_shape)),
        "node": node_state(n),
    }


def mvn_ard_from_state(state, device=None, dtype=None):
    """This package's MVN_ard holding ``state``, on ``device`` in ``dtype``."""
    device = default_device(device)
    from ..dists.mvn_ard import MVN_ard

    n = MVN_ard.create(**state["config"], generator=torch.Generator().manual_seed(0),
                       dtype=torch.float64, device="cpu")
    return load_state(n, state["node"]).to(device, dtype)


def _mnlr_config(model, n):
    return dict(n=n, p=model.p - int(model.pad_X),
                batch_shape=tuple(model.batch_shape), pad_X=bool(model.pad_X))


def mnlr_state(model):
    """Nested dict of numpy arrays holding a MultiNomialLogisticRegression."""
    return {"config": _mnlr_config(model, model.n + 1), "beta": node_state(model.beta)}


def bouchard_state(model):
    """Nested dict of numpy arrays holding a
    MultiNomialLogisticRegression_Bouchard."""
    return {"config": _mnlr_config(model, model.n), "beta": node_state(model.beta)}


def _classifier_from_state(cls, state, device, dtype):
    model = cls(**state["config"], generator=torch.Generator().manual_seed(0),
                dtype=torch.float64, device="cpu")
    model.beta = load_state(model.beta, state["beta"])
    return model.to(device, dtype)


def mnlr_from_state(state, device=None, dtype=None):
    """This package's MNLR holding ``state``, on ``device`` in ``dtype``."""
    device = default_device(device)
    from ..transforms import MultiNomialLogisticRegression

    return _classifier_from_state(MultiNomialLogisticRegression, state, device, dtype)


def bouchard_from_state(state, device=None, dtype=None):
    """This package's Bouchard MNLR holding ``state``, on ``device`` in
    ``dtype``."""
    device = default_device(device)
    from ..transforms import MultiNomialLogisticRegression_Bouchard

    return _classifier_from_state(
        MultiNomialLogisticRegression_Bouchard, state, device, dtype
    )


def dmixlt_state(model):
    """Nested dict of numpy arrays holding a dMixtureofLinearTransforms
    (experts A and gate pi)."""
    return {
        # model.p holds the last responsibilities; the input width is A's
        "config": dict(n=model.n, p=model.A.p - int(model.A.pad_X),
                       mixture_dim=model.mix_dim,
                       batch_shape=tuple(model.batch_shape),
                       pad_X=bool(model.A.pad_X),
                       fixed_precision=bool(model.A.fixed_precision)),
        "A": node_state(model.A),
        "pi": node_state(model.pi.beta),
    }


def dmixlt_from_state(state, device=None, dtype=None):
    """This package's dMixLT holding ``state``, on ``device`` in ``dtype``."""
    device = default_device(device)
    from ..transforms import dMixtureofLinearTransforms

    model = dMixtureofLinearTransforms(
        **state["config"], generator=torch.Generator().manual_seed(0),
        dtype=torch.float64, device="cpu",
    )
    model.A = load_state(model.A, state["A"])
    model.pi.beta = load_state(model.pi.beta, state["pi"])
    return model.to(device, dtype)


def nlrm_state(model):
    """Nested dict of numpy arrays holding an NLRegression_Multinomial
    (experts A and gate Z)."""
    return {
        # model.p holds the last responsibilities (None before a fit); the
        # input width is A's, less its bias column
        "config": dict(n=model.n, p=model.A.p - 1, mixture_dim=model.mixture_dim,
                       batch_shape=tuple(model.batch_shape)),
        "A": node_state(model.A),
        "Z": node_state(model.Z.beta),
    }


def nlrm_from_state(state, device=None, dtype=None):
    """This package's NLRegression_Multinomial holding ``state``, on
    ``device`` in ``dtype``."""
    device = default_device(device)
    from ..transforms import NLRegression_Multinomial

    model = NLRegression_Multinomial(
        **state["config"], generator=torch.Generator().manual_seed(0),
        dtype=torch.float64, device="cpu",
    )
    model.A = load_state(model.A, state["A"])
    model.Z.beta = load_state(model.Z.beta, state["Z"])
    return model.to(device, dtype)


# -- the ARHMM family, dHMM and NLDS -------------------------------------------
def arhmm_state(model):
    """Nested dict of numpy arrays holding an ARHMM, ARHMM_prXY or
    ARHMM_prXRY: its class and configuration (ptemp, parallel_scan and
    pad_X among them), its Dirichlets, transition_mask, the MNW emission
    (masks included) and p when the model has run."""
    obs = model.obs_dist
    kind = type(model).__name__
    config = dict(dim=obs.batch_shape[-1], n=obs.n,
                  batch_shape=tuple(obs.batch_shape[:-1]), pad_X=bool(obs.pad_X))
    if kind == "ARHMM_prXRY":
        config.update(p1=model.p1, p2=model.p2)
    else:
        config.update(p=obs.p - int(obs.pad_X))
    mask = model.transition_mask
    state = {
        "kind": kind,
        "config": config,
        "ptemp": float(model.ptemp),
        "parallel_scan": bool(model.parallel_scan),
        "transition": node_state(model.transition),
        "initial": node_state(model.initial),
        "transition_mask": None if mask is None else _array(mask),
        "obs_dist": node_state(obs),
    }
    if model.p is not None:
        state["p"] = _array(model.p)
    return state


def arhmm_from_state(state, device=None, dtype=None):
    """This package's ARHMM, ARHMM_prXY or ARHMM_prXRY holding ``state``, on
    ``device`` in ``dtype``."""
    device = default_device(device)
    from .. import models

    mask = state["transition_mask"]
    model = getattr(models, state["kind"])(
        **state["config"],
        transition_mask=None if mask is None else torch.tensor(np.asarray(mask)),
        generator=torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu",
    )
    model.ptemp = state["ptemp"]
    model.parallel_scan = state["parallel_scan"]
    model.transition = load_state(model.transition, state["transition"])
    model.initial = load_state(model.initial, state["initial"])
    model.obs_dist = load_state(model.obs_dist, state["obs_dist"])
    _load_p(model, state)
    return model.to(device, dtype)


def dhmm_state(model):
    """Nested dict of numpy arrays holding a dHMM with NormalInverseWishart
    observations: its configuration (ptemp, parallel_scan), the MNLR
    transition's weights, the initial Dirichlet, the observation model and p
    when the model has run."""
    obs = model.obs_dist
    state = {
        "config": dict(event_shape=tuple(obs.event_shape),
                       batch_shape=tuple(obs.batch_shape),
                       p=model.transition.p - 1,
                       ptemp=float(model.ptemp),
                       parallel_scan=bool(model.parallel_scan)),
        "transition": node_state(model.transition.beta),
        "initial": node_state(model.initial),
        "obs_dist": node_state(obs),
    }
    if model.p is not None:
        state["p"] = _array(model.p)
    return state


def dhmm_from_state(state, device=None, dtype=None):
    """This package's dHMM (NormalInverseWishart observations) holding
    ``state``, on ``device`` in ``dtype``."""
    device = default_device(device)
    from ..dists import NormalInverseWishart
    from ..models import dHMM

    cfg = state["config"]
    g = torch.Generator().manual_seed(0)
    obs = NormalInverseWishart.create(cfg["event_shape"], cfg["batch_shape"], generator=g,
                                      dtype=torch.float64, device="cpu")
    model = dHMM(load_state(obs, state["obs_dist"]), cfg["p"], ptemp=cfg["ptemp"],
                 parallel_scan=cfg["parallel_scan"], generator=g, dtype=torch.float64,
                 device="cpu")
    model.transition.beta = load_state(model.transition.beta, state["transition"])
    model.initial = load_state(model.initial, state["initial"])
    _load_p(model, state)
    return model.to(device, dtype)


_NLDS_NODES = ("x0", "A", "B", "pi0")


def nlds_state(model):
    """Nested dict of numpy arrays holding an NLDS: its configuration, the
    nodes x0 (NormalInverseWishart), A and B (MatrixNormalWishart), pi0
    (Dirichlet), the transition MNLR's weights T, and p (q(s)) when set."""
    state = {
        "config": dict(obs_shape=tuple(model.obs_shape), hidden_dim=model.hidden_dim,
                       mixture_dim=model.mixture_dim),
        **{k: node_state(getattr(model, k)) for k in _NLDS_NODES},
        "T": node_state(model.T.beta),
    }
    if model.p is not None:
        state["p"] = _array(model.p)
    return state


def nlds_from_state(state, device=None, dtype=None):
    """This package's NLDS holding ``state``, on ``device`` in ``dtype``."""
    device = default_device(device)
    from ..models import NLDS

    model = NLDS(**state["config"], generator=torch.Generator().manual_seed(0),
                 dtype=torch.float64, device="cpu")
    for k in _NLDS_NODES:
        setattr(model, k, load_state(getattr(model, k), state[k]))
    model.T.beta = load_state(model.T.beta, state["T"])
    _load_p(model, state)
    return model.to(device, dtype)


# -- mixtures ------------------------------------------------------------------
def gmm_state(model):
    """Nested dict of numpy arrays holding a GaussianMixtureModel (NIW or,
    isotropic, NormalGamma components), a PoissonMixtureModel or a
    GMM_vector (NormalInverseWishart_vector_format components): its
    configuration (``kind`` names the component node), pi (Dirichlet) and
    the component node ``dist``."""
    kind = type(model.dist).__name__
    if kind not in ("NormalInverseWishart", "NormalGamma", "Gamma",
                    "NormalInverseWishart_vector_format"):
        raise ValueError(f"no mixture model has {kind} components")
    # NormalInverseWishart_vector_format's event is (dim, 1)
    dim = model.dist.event_shape[-2 if kind.endswith("vector_format") else -1]
    return {
        "config": dict(kind=kind, nc=model.event_shape[0], dim=dim),
        "pi": node_state(model.pi),
        "dist": node_state(model.dist),
    }


def gmm_from_state(state, device=None, dtype=None):
    """This package's mixture model holding ``state``, on ``device`` in
    ``dtype``."""
    device = default_device(device)
    from ..models import GaussianMixtureModel, PoissonMixtureModel

    from ..dists import GMM_vector

    c = state["config"]
    g = torch.Generator().manual_seed(0)
    if c["kind"] == "NormalInverseWishart_vector_format":
        model = GMM_vector(c["nc"], c["dim"], generator=g, dtype=torch.float64, device="cpu")
    elif c["kind"] == "Gamma":
        model = PoissonMixtureModel(c["nc"], c["dim"], generator=g, dtype=torch.float64,
                                    device="cpu")
    else:
        model = GaussianMixtureModel(c["nc"], c["dim"], isotropic=c["kind"] == "NormalGamma",
                                     generator=g, dtype=torch.float64, device="cpu")
    model.pi = load_state(model.pi, state["pi"])
    model.dist = load_state(model.dist, state["dist"])
    return model.to(device, dtype)


# -- the tensor-state HMMs -------------------------------------------------------
def tensor_hmm_state(model):
    """Nested dict of numpy arrays holding a Tensor_HMM, HHMM or
    Factorial_HMM with NormalInverseWishart observations: its class under
    ``kind``, its configuration (ptemp among it), the transition (a
    Transition, or a HierarchicalTransition's list of Dirichlets), the
    initial Dirichlet, the observation model and p when the model has run.
    A Factorial_HMM's projection (``marg_sum_list``) is rebuilt from the
    configuration."""
    kind = type(model).__name__
    obs = model.obs_dist
    if kind == "Factorial_HMM":
        config = dict(num_factors=model.num_factors, factor_shape=tuple(model.factor_shape),
                      event_shape=tuple(obs.event_shape), batch_shape=tuple(model.batch_shape))
    else:
        config = dict(event_shape=tuple(model.event_shape))
        if kind == "HHMM":
            config["event_dim"] = model.event_dim
    state = {
        "kind": kind,
        "config": config,
        "ptemp": float(model.ptemp),
        "obs_shapes": dict(event_shape=tuple(obs.event_shape),
                           batch_shape=tuple(obs.batch_shape)),
        "transition": node_state(model.transition),
        "initial": node_state(model.initial),
        "obs_dist": node_state(obs),
    }
    if model.p is not None:
        state["p"] = _array(model.p)
    return state


def tensor_hmm_from_state(state, device=None, dtype=None):
    """This package's Tensor_HMM, HHMM or Factorial_HMM holding ``state``,
    on ``device`` in ``dtype``."""
    device = default_device(device)
    from .. import models
    from ..dists import NormalInverseWishart

    g = torch.Generator().manual_seed(0)
    kw = dict(generator=g, dtype=torch.float64, device="cpu")
    cls = getattr(models, state["kind"])
    if state["kind"] == "Factorial_HMM":
        model = cls(**state["config"], **kw)
    else:
        obs = NormalInverseWishart.create(**state["obs_shapes"], **kw)
        model = cls(obs, **state["config"], **kw)
    model.ptemp = state["ptemp"]
    model.transition = load_state(model.transition, state["transition"])
    model.initial = load_state(model.initial, state["initial"])
    model.obs_dist = load_state(model.obs_dist, state["obs_dist"])
    _load_p(model, state)
    return model.to(device, dtype)
