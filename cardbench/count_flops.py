"""Count the matrix-product operations of one sweep of the plain reference
at a cell's shapes and store them as ``flops_per_sweep`` in the cell's file
(``cardbench/workloads/<cell>.json``), for the ``sweep_mfu_pct`` metric.

    python3 cardbench/count_flops.py [cell ...]

Counted: every matrix product and contraction of the reference's sweep
(``torch.utils.flop_counter``: 2 m n k a product).  Left out: elementwise
work, reductions, special functions, and the inverses, determinants and
solves.  So the count, and the share of the peak made from it, is a lower
bound, fixed whatever the program's implementation.  Runs on the CPU in
float32; the count depends on the shapes alone.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from cardbench.reference import dmbd as ref  # noqa: E402
from cardbench.run import driver, load_cell  # noqa: E402


def count(name):
    _, cfg, traffic, _, _, _ = load_cell(name)
    inputs = driver(cfg).make_inputs(cfg, traffic, 0, "cpu")
    y = inputs["y"]
    pr = ref.priors(cfg, y.dtype, y.device)
    st = ref.start(cfg, inputs["state"], y.dtype, y.device)
    st, _ = ref.sweep(st, y, pr, traffic["lr"])  # the first sweep starts with no latent posterior
    with FlopCounterMode(display=False) as fc:
        ref.sweep(st, y, pr, traffic["lr"])
    return fc.get_total_flops()


def main(names):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in names or [w["name"] for w in spec["workloads"]]:
        path = ROOT / "cardbench" / "workloads" / f"{name}.json"
        own = json.loads(path.read_text())
        own["flops_per_sweep"] = count(name)
        path.write_text(json.dumps(own, indent=1) + "\n")
        print(name, own["flops_per_sweep"])


if __name__ == "__main__":
    main(sys.argv[1:])
