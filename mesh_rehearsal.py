#!/usr/bin/env python3
"""A CPU rehearsal of chip_smoke.py phase 39 leg (h): the tensor HMMs and
NLDS under data_parallel_update on four gloo ranks of the CPU, in float32,
at the leg's widths, data and states.

    python3 mesh_rehearsal.py

Needs no card.  For each model of leg (h) it prints, on rank 0, the
collectives' bytes and elements a sweep by tag, whether every rank ends
with the same ELBOs and parameter nodes, the ELBOs' largest relative
deviation from the single process's and the lane scan's shape on each
rank (NLDS).  Its counts are what the card run should show; its rates are
the CPU's and say nothing of the card's.
"""
from __future__ import annotations

import datetime
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import chip_smoke as cs

WORLD = 4
LEGS = [leg for leg in cs.MESH_LEGS if leg.startswith("h_")]


def rank_main(rank, workdir):
    from pyvbmp_tpu_torch.parallel import data_parallel_update, make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        data = np.load(Path(workdir) / "inputs.npy", allow_pickle=True).item()
        mesh = make_mesh(WORLD, "data")
        out = {}
        for leg in LEGS:
            name = cs.MESH_LEGS[leg][0]
            make, (y,) = cs._mesh_model(name, data, None, "cpu")
            m = make()
            mesh.reset_counts()
            data_parallel_update(m, y, mesh=mesh,
                                 iters=1 if leg in cs.ONE_SWEEP_LEGS else cs.MESH_SWEEPS)
            out[leg] = dict(elbo=list(m.ELBO_save), params=cs._param_vector(m),
                            nbytes={t: mesh.nbytes(t) for t in cs.MESH_TAGS},
                            elements={t: mesh.elements(t) for t in cs.MESH_TAGS},
                            px=tuple(m.px.mu.shape) if name.startswith("nlds") else None)
        np.save(Path(workdir) / f"rank{rank}.npy", out, allow_pickle=True)
    finally:
        dist.destroy_process_group()


def main():
    with tempfile.TemporaryDirectory() as workdir:
        data = cs.data_leg_inputs()
        np.save(Path(workdir) / "inputs.npy", data, allow_pickle=True)
        mp.spawn(rank_main, args=(workdir,), nprocs=WORLD, join=True)
        ranks = [np.load(Path(workdir) / f"rank{r}.npy", allow_pickle=True).item()
                 for r in range(WORLD)]
    for leg in LEGS:
        name = cs.MESH_LEGS[leg][0]
        first = ranks[0][leg]
        sweeps = len(first["elbo"])
        nbytes, elements = ({t: n // sweeps for t, n in first[k].items() if n}
                            for k in ("nbytes", "elements"))
        same_elbo = all(r[leg]["elbo"] == first["elbo"] for r in ranks)
        same_params = all(np.array_equal(r[leg]["params"], first["params"]) for r in ranks)
        line = (f"{leg}: bytes a sweep {nbytes}, elements {elements}; ELBOs equal on every "
                f"rank {same_elbo}, parameters {same_params}")
        if first["px"] is not None:
            T, b, h = first["px"][:3]
            line += f"; lane scan (T, H, lanes) on each rank {(T, h, b)}"
        if leg not in cs.ONE_SWEEP_LEGS:
            make, (y,) = cs._mesh_model(name, data, None, "cpu")
            single = make()
            single.update(y, iters=sweeps)
            ref = np.asarray(single.ELBO_save)
            dev = np.max(np.abs(np.asarray(first["elbo"]) - ref) / np.abs(ref))
            line += f"; max rel dev from the single process {dev:.3e}"
        print(line, flush=True)


if __name__ == "__main__":
    main()
