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
  before building anything).  These four and ``dhmm_from_state`` take a
  ``time_mesh`` (a ``parallel.Mesh``) to build the model with; a mesh is
  placement, not state, so no dict carries one (a JAX model's mesh is not
  read).

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

The transform shells of the JAX package's ``transforms`` have the same
pair of functions, each dict holding the constructor arguments under
``config`` and one entry per posterior node (a list of them for the
multilinear model's factors): ``multilinear_state``, ``rrr_state``,
``mixlt_state``, ``dmixture_state`` (the component node's class under
``config.kind``), ``nlr_full_state``, ``nlr_low_state``, ``nlr_orig_state``,
``gbt_state``, ``fbt_state`` and ``cbt_state``; ``tnw_state`` carries a
TensorNormalWishart.  The transformers' latents and every shell's last
assignments are not carried: a model loaded from a state starts them afresh,
as a new model does.

The classifiers have the same pair of functions: ``mvn_ard_state`` (an
MVN_ard node with its Gamma, and its shapes), ``mnlr_state``,
``bouchard_state``, ``dmixlt_state`` and ``nlrm_state``, each with its
``..._from_state``.  Their dicts hold the constructor arguments under
``config`` and one entry per posterior node (``beta``; ``A`` and ``pi``;
``A`` and ``Z``).

The last two models have the same pair of functions: ``bfa_state`` (a
BayesianFactorAnalysis: its shapes and the loading matrix A) and
``bayesnet_state`` (a BayesNet: its widths, each layer as a
``dmixlt_state`` and the head as an ``mnlr_state``), each with its
``..._from_state``.

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

from .torchutils import default_device, require_whole_state

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
    require_whole_state(model)
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


def dmbd_from_state(state, device=None, dtype=None, time_mesh=None):
    """This package's DMBD holding ``state``, on ``device`` in ``dtype``,
    built with ``time_mesh``."""
    device = default_device(device)
    from ..models import DynamicMarkovBlanketDiscovery

    model = DynamicMarkovBlanketDiscovery(
        **state["config"], time_mesh=time_mesh,
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
    require_whole_state(model)
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


def hmm_from_state(state, device=None, dtype=None, time_mesh=None):
    """This package's HMM (NormalInverseWishart observations) holding
    ``state``, on ``device`` in ``dtype``, built with ``time_mesh``."""
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
        ptemp=cfg["ptemp"], parallel_scan=cfg["parallel_scan"], time_mesh=time_mesh,
        generator=g, dtype=torch.float64, device="cpu",
    )
    model.transition = load_state(model.transition, state["transition"])
    model.initial = load_state(model.initial, state["initial"])
    _load_p(model, state)
    return model.to(device, dtype)


def _lds_nodes(lds):
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
    require_whole_state(model)
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


def lds_from_state(state, device=None, dtype=None, time_mesh=None):
    """This package's LDS holding ``state``, on ``device`` in ``dtype``,
    built with ``time_mesh``."""
    device = default_device(device)
    from ..dists.mvn_vector_format import MultivariateNormal_vector_format
    from ..models import LinearDynamicalSystems

    g = torch.Generator().manual_seed(0)
    model = LinearDynamicalSystems(
        **state["config"], obs_model=_obs_model(state, g), time_mesh=time_mesh,
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
    require_whole_state(model)
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


def mixlds_from_state(state, device=None, dtype=None, time_mesh=None):
    """This package's MixLDS holding ``state``, on ``device`` in ``dtype``,
    built with ``time_mesh``."""
    device = default_device(device)
    from ..models import MixtureofLinearDynamicalSystems

    model = MixtureofLinearDynamicalSystems(
        **state["config"], time_mesh=time_mesh,
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


def _expert_type(A):
    """The ``type`` argument that builds experts like A."""
    return "Gamma" if type(A).__name__.startswith("MatrixNormalGamma") else "Wishart"


def dmixlt_state(model):
    """Nested dict of numpy arrays holding a dMixtureofLinearTransforms
    (experts A and gate pi)."""
    return {
        # model.p holds the last responsibilities; the input width is A's
        "config": dict(n=model.n, p=model.A.p - int(model.A.pad_X),
                       mixture_dim=model.mix_dim,
                       batch_shape=tuple(model.batch_shape),
                       pad_X=bool(model.A.pad_X),
                       type=_expert_type(model.A),
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
    require_whole_state(model)
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


def dhmm_from_state(state, device=None, dtype=None, time_mesh=None):
    """This package's dHMM (NormalInverseWishart observations) holding
    ``state``, on ``device`` in ``dtype``, built with ``time_mesh``."""
    device = default_device(device)
    from ..dists import NormalInverseWishart
    from ..models import dHMM

    cfg = state["config"]
    g = torch.Generator().manual_seed(0)
    obs = NormalInverseWishart.create(cfg["event_shape"], cfg["batch_shape"], generator=g,
                                      dtype=torch.float64, device="cpu")
    model = dHMM(load_state(obs, state["obs_dist"]), cfg["p"], ptemp=cfg["ptemp"],
                 parallel_scan=cfg["parallel_scan"], time_mesh=time_mesh, generator=g,
                 dtype=torch.float64, device="cpu")
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


# -- the transform shells ------------------------------------------------------------
def _nodes_state(v):
    return [node_state(x) for x in v] if isinstance(v, list) else node_state(v)


def _shell_state(model, config, names):
    """``config`` and the state of each node attribute in ``names``."""
    return {"config": config, **{n: _nodes_state(getattr(model, n)) for n in names}}


def _load_nodes(cur, v):
    if isinstance(cur, list):
        if len(v) != len(cur):
            raise ValueError(f"state has {len(v)} nodes, model has {len(cur)}")
        return [load_state(c, x) for c, x in zip(cur, v)]
    return load_state(cur, v)


def _shell_from_state(cls, state, device, dtype, names):
    """``cls`` built on the CPU in float64 from the state's config, its
    nodes ``names`` loaded, then moved to ``device`` in ``dtype``."""
    device = default_device(device)
    model = cls(**state["config"], generator=torch.Generator().manual_seed(0),
                dtype=torch.float64, device="cpu")
    for n in names:
        setattr(model, n, _load_nodes(getattr(model, n), state[n]))
    return model.to(device, dtype)


def _transform(name):
    from .. import transforms

    return getattr(transforms, name)


def tnw_state(n):
    """Nested dict of numpy arrays holding a TensorNormalWishart."""
    return {"config": dict(event_shape=tuple(n.event_shape), batch_shape=tuple(n.batch_shape)),
            "node": node_state(n)}


def tnw_from_state(state, device=None, dtype=None):
    """This package's TensorNormalWishart holding ``state``, on ``device``
    in ``dtype``."""
    device = default_device(device)
    from ..dists import TensorNormalWishart

    n = TensorNormalWishart.create(**state["config"], generator=torch.Generator().manual_seed(0),
                                   dtype=torch.float64, device="cpu")
    return load_state(n, state["node"]).to(device, dtype)


_MULTILINEAR_NODES = ("A", "bias", "invSigma")


def multilinear_state(model):
    """Nested dict of numpy arrays holding a MultiLinearNormalWishart (the
    factors A, the bias and the shared noise invSigma)."""
    config = dict(n=model.n, p_list=list(model.p_list), batch_shape=tuple(model.batch_shape),
                  noise_type=model.noise_type)
    return _shell_state(model, config, _MULTILINEAR_NODES)


def multilinear_from_state(state, device=None, dtype=None):
    """This package's MultiLinearNormalWishart holding ``state``, on
    ``device`` in ``dtype`` (its factors share the loaded noise node)."""
    return _shell_from_state(_transform("MultiLinearNormalWishart"), state, device, dtype,
                             _MULTILINEAR_NODES)


def rrr_state(model):
    """Nested dict of numpy arrays holding a ReducedRankRegression."""
    config = dict(n=model.n, p=model.p, dim=model.dim, batch_shape=tuple(model.batch_shape),
                  pad_X=bool(model.A.pad_X), independent=_expert_type(model.A) == "Gamma")
    return _shell_state(model, config, ("A", "B", "U"))


def rrr_from_state(state, device=None, dtype=None):
    """This package's ReducedRankRegression holding ``state``, on ``device``
    in ``dtype``."""
    return _shell_from_state(_transform("ReducedRankRegression"), state, device, dtype,
                             ("A", "B", "U"))


def mixlt_state(model):
    """Nested dict of numpy arrays holding a MixtureofLinearTransforms."""
    # model.p holds the last assignments; the input width is W's
    config = dict(n=model.n, p=model.W.p - int(model.W.pad_X), dim=model.dim,
                  batch_shape=tuple(model.batch_shape), pad_X=bool(model.W.pad_X),
                  type=_expert_type(model.W))
    return _shell_state(model, config, ("W", "pi"))


def mixlt_from_state(state, device=None, dtype=None):
    """This package's MixtureofLinearTransforms holding ``state``, on
    ``device`` in ``dtype``."""
    return _shell_from_state(_transform("MixtureofLinearTransforms"), state, device, dtype,
                             ("W", "pi"))


def dmixture_state(model):
    """Nested dict of numpy arrays holding a dMixture: the component node
    (its class, shapes and state) and the gate's weights."""
    d = model.dist
    return {
        "config": dict(kind=type(d).__name__, event_shape=tuple(d.event_shape),
                       batch_shape=tuple(d.batch_shape),
                       p=model.pi.p - int(model.pi.pad_X)),
        "dist": node_state(d),
        "pi": node_state(model.pi.beta),
    }


def dmixture_from_state(state, device=None, dtype=None):
    """This package's dMixture holding ``state``, on ``device`` in
    ``dtype``."""
    device = default_device(device)
    from .. import dists

    c = state["config"]
    kw = dict(generator=torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu")
    dist = getattr(dists, c["kind"]).create(c["event_shape"], c["batch_shape"], **kw)
    model = _transform("dMixture")(load_state(dist, state["dist"]), c["p"], **kw)
    model.pi.beta = load_state(model.pi.beta, state["pi"])
    return model.to(device, dtype)


def nlr_full_state(model):
    """Nested dict of numpy arrays holding an NLRegression_full_rank."""
    config = dict(n=model.A.n, p=model.A.p - 1, mixture_dim=model.pi.event_shape[-1],
                  batch_shape=tuple(model.batch_shape), independent=bool(model.independent))
    return _shell_state(model, config, ("A", "X", "pi"))


def nlr_full_from_state(state, device=None, dtype=None):
    """This package's NLRegression_full_rank holding ``state``, on
    ``device`` in ``dtype``."""
    return _shell_from_state(_transform("NLRegression_full_rank"), state, device, dtype,
                             ("A", "X", "pi"))


def nlr_low_state(model):
    """Nested dict of numpy arrays holding an NLRegression_low_rank."""
    config = dict(n=model.A.n, p=model.W.n, hidden_dim=model.hidden_dim,
                  mixture_dim=model.mixture_dim, batch_shape=tuple(model.batch_shape),
                  independent=bool(model.independent))
    return _shell_state(model, config, ("A", "W", "U", "pi"))


def nlr_low_from_state(state, device=None, dtype=None):
    """This package's NLRegression_low_rank holding ``state``, on ``device``
    in ``dtype``."""
    return _shell_from_state(_transform("NLRegression_low_rank"), state, device, dtype,
                             ("A", "W", "U", "pi"))


def nlr_orig_state(model):
    """Nested dict of numpy arrays holding an NLRegression_orig (U's
    precision is W's: loading re-binds it)."""
    # model.p holds the last assignments once fit; the input width is W's
    config = dict(n=model.n, p=model.W.p, hidden_dim=model.hidden_dim,
                  mixture_dim=model.mixture_dim, batch_shape=tuple(model.batch_shape))
    return _shell_state(model, config, ("W", "A", "U", "pi"))


def nlr_orig_from_state(state, device=None, dtype=None):
    """This package's NLRegression_orig holding ``state``, on ``device`` in
    ``dtype``."""
    from ..transforms.nl_regression import NLRegression_orig

    return _shell_from_state(NLRegression_orig, state, device, dtype, ("W", "A", "U", "pi"))


def _transformer_config(model):
    return dict(mixture_dim=model.mixture_dim, role_dim=model.role_dim,
                obs_dim=model.obs_dim, hidden_dim=model.hidden_dim,
                batch_shape=tuple(model.batch_shape))


def gbt_state(model):
    """Nested dict of numpy arrays holding a GenerativeBayesianTransformer."""
    config = dict(_transformer_config(model), pad_X=bool(model.A.pad_X))
    return _shell_state(model, config, ("A", "pi_role", "pi_mix"))


def gbt_from_state(state, device=None, dtype=None):
    """This package's GenerativeBayesianTransformer holding ``state``, on
    ``device`` in ``dtype``."""
    return _shell_from_state(_transform("GenerativeBayesianTransformer"), state, device, dtype,
                             ("A", "pi_role", "pi_mix"))


def fbt_state(model):
    """Nested dict of numpy arrays holding a FocusedBayesianTransformer (its
    heads W as a ``dmixlt_state``)."""
    return {"config": dict(_transformer_config(model), pad_X=bool(model.W.A.pad_X)),
            "W": dmixlt_state(model.W), "pi": node_state(model.pi)}


def fbt_from_state(state, device=None, dtype=None):
    """This package's FocusedBayesianTransformer holding ``state``, on
    ``device`` in ``dtype``."""
    device = default_device(device)
    model = _transform("FocusedBayesianTransformer")(
        **state["config"], generator=torch.Generator().manual_seed(0),
        dtype=torch.float64, device="cpu")
    model.W.A = load_state(model.W.A, state["W"]["A"])
    model.W.pi.beta = load_state(model.W.pi.beta, state["W"]["pi"])
    model.pi = load_state(model.pi, state["pi"])
    return model.to(device, dtype)


def cbt_state(model):
    """Nested dict of numpy arrays holding a ChainedBayesianTransformer."""
    config = dict(mixture_dim=model.mixture_dim, role_dim=model.role_dim, n=model.obs_dim,
                  p=model.regression_dim, batch_shape=tuple(model.batch_shape))
    return _shell_state(model, config, ("x0", "W", "pi"))


def cbt_from_state(state, device=None, dtype=None):
    """This package's ChainedBayesianTransformer holding ``state``, on
    ``device`` in ``dtype``."""
    return _shell_from_state(_transform("ChainedBayesianTransformer"), state, device, dtype,
                             ("x0", "W", "pi"))


# -- factor analysis and the BayesNet --------------------------------------------
def bfa_state(model):
    """Nested dict of numpy arrays holding a BayesianFactorAnalysis: its
    shapes under ``config`` and the loading matrix A (MatrixNormalGamma).
    The latents q(z) are not carried."""
    return {"config": dict(obs_dim=model.obs_dim, latent_dim=model.latent_dim,
                           batch_shape=tuple(model.batch_shape)),
            "A": node_state(model.A)}


def bfa_from_state(state, device=None, dtype=None):
    """This package's BayesianFactorAnalysis holding ``state``, on ``device``
    in ``dtype``."""
    device = default_device(device)
    from ..models import BayesianFactorAnalysis

    model = BayesianFactorAnalysis(**state["config"], generator=torch.Generator().manual_seed(0),
                                   dtype=torch.float64, device="cpu")
    model.A = load_state(model.A, state["A"])
    return model.to(device, dtype)


def bayesnet_state(model):
    """Nested dict of numpy arrays holding a BayesNet: its widths under
    ``config``, each layer as a ``dmixlt_state`` and the head as an
    ``mnlr_state``."""
    # a layer's ``p`` holds its last responsibilities once fit; the input
    # width is its experts', less their bias column
    return {"config": dict(n=model.head.n + 1, p=model.layers[0].A.p - 1,
                           hidden_dims=tuple(model.hidden_dims),
                           mixture_dims=tuple(model.mixture_dims),
                           batch_shape=tuple(model.batch_shape)),
            "layers": [dmixlt_state(layer) for layer in model.layers],
            "head": mnlr_state(model.head)}


def bayesnet_from_state(state, device=None, dtype=None):
    """This package's BayesNet holding ``state``, on ``device`` in ``dtype``."""
    device = default_device(device)
    from ..models import BayesNet

    model = BayesNet(**state["config"], generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64, device="cpu")
    if len(state["layers"]) != model.num_layers:
        raise ValueError(f"state has {len(state['layers'])} layers, model has "
                         f"{model.num_layers}")
    for layer, st in zip(model.layers, state["layers"]):
        layer.A = load_state(layer.A, st["A"])
        layer.pi.beta = load_state(layer.pi.beta, st["pi"])
    model.head.beta = load_state(model.head.beta, state["head"]["beta"])
    return model.to(device, dtype)
