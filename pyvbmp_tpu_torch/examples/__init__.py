"""The examples of the JAX package (``examples/``), one module each under the
same name, on this package: ``python -m pyvbmp_tpu_torch.examples.<name>``
runs one on the card.

Each module has its data (``load_*``/``make_data``: the JAX example's numpy
pipeline as it is, or the simulator of ``pyvbmp_tpu_torch.simulations``),
``build_model(generator, device, dtype)``, ``fit(model, data)`` with the JAX
example's schedule, and ``main(..., device=None, smoke=None, plots=True)``.
``smoke`` defaults to the environment variable ``PYVBMP_EXAMPLE_SMOKE`` and
shrinks the run to the JAX example's smoke widths; ``plots`` writes the
example's figures where matplotlib is installed (into the temporary
directory in smoke mode, else the working directory)."""
