"""The port's public surface against the JAX package's: every class that
``pyvbmp_tpu.{dists,transforms,models}`` exports is exported by
``pyvbmp_tpu_torch`` under the same name, with every public attribute of the
JAX class (methods, properties and dataclass fields; names that start with
``_`` are private and not compared).  A gap fails unless it stands in
``NOT_PORTED`` with its reason, so a method missing from a class that counts
as ported cannot come back unseen.  What the methods compute is held to the
JAX package elsewhere (``tests/test_torch_nodes.py``,
``tests/test_torch_transforms.py`` and the per-model files)."""
import dataclasses
import importlib

import pytest

SUBPACKAGES = ("dists", "transforms", "models")

# (subpackage, class) -> why the port does not export it yet
NOT_PORTED = {}
# (subpackage, class, attribute) -> why the port's class lacks it
MISSING_ATTRIBUTES = {}


def _modules(sub):
    return (importlib.import_module(f"pyvbmp_tpu.{sub}"),
            importlib.import_module(f"pyvbmp_tpu_torch.{sub}"))


def _public(cls):
    names = {a for a in dir(cls) if not a.startswith("_")}
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")}
    return names


def _jax_classes():
    out = []
    for sub in SUBPACKAGES:
        jax_mod, _ = _modules(sub)
        out += [(sub, name) for name in sorted(jax_mod.__all__)]
    return out


@pytest.mark.parametrize("sub,name", _jax_classes(), ids=lambda x: str(x))
def test_port_has_the_jax_class_and_its_public_attributes(sub, name):
    jax_mod, port_mod = _modules(sub)
    if (sub, name) in NOT_PORTED:
        assert name not in port_mod.__all__, f"{name} is ported: drop it from NOT_PORTED"
        return
    assert name in port_mod.__all__, f"pyvbmp_tpu_torch.{sub} does not export {name}"
    missing = _public(getattr(jax_mod, name)) - _public(getattr(port_mod, name))
    missing -= {a for s, c, a in MISSING_ATTRIBUTES if (s, c) == (sub, name)}
    assert not missing, f"{sub}.{name} lacks {sorted(missing)}"


def test_aliases_match():
    """A name the JAX package binds to another exported class is bound the
    same way in the port (the Discrete transformer is the Focused one)."""
    for sub in SUBPACKAGES:
        jax_mod, port_mod = _modules(sub)
        for a in jax_mod.__all__:
            for b in jax_mod.__all__:
                if a < b and getattr(jax_mod, a) is getattr(jax_mod, b):
                    assert getattr(port_mod, a) is getattr(port_mod, b), (sub, a, b)


def test_exception_lists_name_real_classes():
    for sub, name in NOT_PORTED:
        assert name in _modules(sub)[0].__all__, (sub, name)
    for sub, name, attr in MISSING_ATTRIBUTES:
        assert attr in _public(getattr(_modules(sub)[0], name)), (sub, name, attr)


def test_parallel_exports_match():
    """``pyvbmp_tpu_torch.parallel`` exports every name of
    ``pyvbmp_tpu.parallel.__all__`` and the public functions of its
    ``seq_parallel``, with the JAX signatures; the port adds its ``Mesh``
    (torch.distributed has no mesh of its own), ``shard_pytree_batch``
    (``pyvbmp_tpu.parallel.api`` has it, its ``__all__`` does not) and
    ``gather_posterior`` (a time-sharded sweep keeps each rank's chunk,
    where XLA keeps the shards).
    ``sharded_associative_scan``, ``shift_up`` and ``shift_down`` take the
    mesh and its axis where the JAX functions, run inside ``shard_map``,
    take an axis name."""
    import inspect

    import pyvbmp_tpu.parallel as jp
    import pyvbmp_tpu.parallel.api as japi
    import pyvbmp_tpu.parallel.seq_parallel as jsp
    import pyvbmp_tpu_torch.parallel as tp

    seq = {n for n, v in vars(jsp).items()
           if inspect.isfunction(v) and not n.startswith("_") and v.__module__ == jsp.__name__}
    assert seq == {"sharded_associative_scan", "shift_up", "shift_down",
                   "time_sharded_forward_backward", "time_sharded_driven_forward_backward",
                   "time_sharded_kalman_smoother"}
    assert set(tp.__all__) - set(jp.__all__) - seq == {"Mesh", "shard_pytree_batch",
                                                        "gather_posterior"}
    for name in set(jp.__all__) | seq | {"shard_pytree_batch"}:
        jax_fn = getattr(japi, name, None) or getattr(jsp, name)
        params = list(inspect.signature(getattr(tp, name)).parameters)
        if name in ("sharded_associative_scan", "shift_up", "shift_down"):
            continue
        assert params == list(inspect.signature(jax_fn).parameters), name
    assert list(inspect.signature(tp.shift_up).parameters) == ["x", "mesh", "axis", "fill"]
