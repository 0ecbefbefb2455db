"""Checkpoint and resume for a model's state (counterpart of
pyvbmp_tpu/utils/checkpoint.py).

``model_state`` walks the model's public attributes as the JAX package's
does: ``ELBO_save`` is skipped, tensors and parameter nodes (and lists of
them) are kept, and nested stateful shells (an NLDS's MNLR transition, a
MixLDS's inner LDS, a BayesNet's layers) are followed two levels down under
dotted keys (``lds.x0``, ``layers.0.A``); a model's ``time_mesh`` is not
followed.  ``save`` writes them with
``torch.save`` as nested dicts of tensors and plain values (a node under
the name of its class in this package, no pickled objects), and ``load``
reads the file back with ``torch.load(..., weights_only=True)`` and sets
each attribute in place by its dotted key.  Every tensor is loaded onto the
device and into the dtype of the tensor it replaces (of the model's first
floating tensor where the attribute was unset), so a card model saved in
float32 loads as a card model in float32, and the same file loads into a
CPU model in float64.

A checkpoint written by the JAX package holds a JAX tree definition and
cannot be read without JAX; this module does not read it.
"""
from __future__ import annotations

import dataclasses
import importlib
import os

import numpy as np
import torch

from .torchutils import require_whole_state

_PACKAGE = __name__.split(".")[0]
_NODE, _LIST, _NUMPY = "__node__", "__list__", "__numpy__"


def _is_state(v):
    """A tensor, a parameter node, or a non-empty list of them."""
    if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v) and not isinstance(v, type):
        return True
    return isinstance(v, list) and len(v) > 0 and all(_is_state(x) for x in v)


def _is_shell(v):
    """A model or transform object of this package holding state of its own
    (a model's ``time_mesh`` is placement, not state)."""
    from ..parallel.api import Mesh

    return (hasattr(v, "__dict__") and not isinstance(v, (type, Mesh)) and not callable(v)
            and type(v).__module__.startswith(_PACKAGE))


def model_state(model, _prefix="", _depth=0):
    """Dotted key -> tensor, node or list of nodes: the model's state."""
    state = {}
    for name, val in vars(model).items():
        if name.startswith("_") or name == "ELBO_save":
            continue
        key = _prefix + name
        if _is_state(val):
            state[key] = val
        elif _depth < 2 and _is_shell(val):
            state.update(model_state(val, key + ".", _depth + 1))
        elif (_depth < 2 and isinstance(val, list) and val
              and all(_is_shell(x) for x in val)):
            for i, x in enumerate(val):
                state.update(model_state(x, f"{key}.{i}.", _depth + 1))
    return state


def _pack(v):
    """Tensors (on the CPU), numpy arrays, nodes and lists as plain nested
    dicts that ``torch.load(weights_only=True)`` reads back."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, np.ndarray):
        return {_NUMPY: torch.from_numpy(np.ascontiguousarray(v))}
    if isinstance(v, list):
        return {_LIST: [_pack(x) for x in v]}
    if dataclasses.is_dataclass(v):
        cls = type(v)
        return {_NODE: f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f.name: _pack(getattr(v, f.name)) for f in dataclasses.fields(v)}}
    return v


def _node_class(name):
    module, qualname = name.split(":")
    if module.split(".")[0] != _PACKAGE:
        raise ValueError(f"checkpoint names {name}, not a class of {_PACKAGE}")
    return getattr(importlib.import_module(module), qualname)


def _place(t, cur, like):
    """``t`` on the device of ``cur`` (a tensor being replaced) or of
    ``like``; floating values also in their dtype."""
    ref = cur if isinstance(cur, torch.Tensor) else like
    dtype = ref.dtype if t.is_floating_point() and ref.is_floating_point() else None
    return t.to(device=ref.device, dtype=dtype)


def _unpack(v, cur, like):
    """The saved value ``v`` rebuilt in place of ``cur`` (None where the
    attribute was unset)."""
    if isinstance(v, torch.Tensor):
        return _place(v, cur, like)
    if isinstance(v, dict) and _NUMPY in v:
        return v[_NUMPY].numpy()
    if isinstance(v, dict) and _LIST in v:
        cur = cur if isinstance(cur, list) and len(cur) == len(v[_LIST]) else [None] * len(v[_LIST])
        return [_unpack(x, c, like) for x, c in zip(v[_LIST], cur)]
    if isinstance(v, dict) and _NODE in v:
        cls = _node_class(v[_NODE])
        fields = v["fields"]
        if isinstance(cur, cls):
            return dataclasses.replace(cur, **{
                k: _unpack(x, getattr(cur, k), like) for k, x in fields.items()})
        return cls(**{k: _unpack(x, None, like) for k, x in fields.items()})
    return v


def _first_float(v):
    if isinstance(v, torch.Tensor):
        return v if v.is_floating_point() else None
    items = v if isinstance(v, list) else (
        [getattr(v, f.name) for f in dataclasses.fields(v)] if dataclasses.is_dataclass(v)
        else [])
    for x in items:
        t = _first_float(x)
        if t is not None:
            return t
    return None


def _resolve(model, key):
    """(object holding the attribute, attribute name) for a dotted key."""
    parts = key.split(".")
    target = model
    for part in parts[:-1]:
        target = target[int(part)] if isinstance(target, list) else getattr(target, part)
    return target, parts[-1]


def save(model, path):
    """Save the model's state (``model_state``) to ``path``; a model holding
    its rank's chunk of a time-sharded update raises (``ValueError``)."""
    require_whole_state(model)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    torch.save({k: _pack(v) for k, v in model_state(model).items()}, path)
    return path


def load(model, path):
    """Restore the state saved by ``save`` into ``model``, in place, on the
    model's device and in its dtype; returns the model."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    like = next((t for t in map(_first_float, model_state(model).values()) if t is not None),
                None)
    if like is None:
        raise ValueError(f"{type(model).__name__} holds no floating tensor to load into")
    for key, v in state.items():
        target, name = _resolve(model, key)
        setattr(target, name, _unpack(v, getattr(target, name, None), like))
    return model
