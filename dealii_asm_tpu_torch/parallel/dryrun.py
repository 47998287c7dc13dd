"""Multi-rank dryrun and the rank launcher of the sharded path (PyTorch).

Counterpart of ``__graft_entry__.dryrun_multichip``: on N ranks it builds
``sharding.py::sharded_solver_step`` (the padded Dirichlet box), runs one
step, and solves the flagship's architecture at a small size through
``run_config`` with ``"n devices"`` N (3D Q4, h-multigrid, Chebyshev-1
around FDM overlap 1, float64 CG over float32 levels, two sharded levels
over a replicated coarse tail, ``__graft_entry__.py:100-130``, which
replicates below 600 DoFs on 8 devices).

``spawn`` starts N ranks with ``torch.multiprocessing`` and a ``file://``
store in a temporary directory (gloo on the CPU, NCCL on CUDA with rank r
on ``cuda:r``), calls ``fn(shards, *args)`` on each, and returns the ranks'
results; the CPU tests and ``chip_smoke.py`` use it.  ``Ranks`` starts
them without waiting, so the caller can work while they run.  Under torchrun the
process group comes from the environment.

    python -m dealii_asm_tpu_torch.parallel.dryrun 4 --device cpu
    torchrun --nproc-per-node N -m dealii_asm_tpu_torch.parallel.dryrun N
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .sharding import (Shards, launched_world_size, process_shards,
                       sharded_solver_step)


def _rank_main(rank, world, store, fn, args, out_dir, device, threads):
    torch.set_num_threads(threads)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            device_id=torch.device("cuda", rank) if cuda
                            else None)
    try:
        shards = process_shards(world, device)
        torch.save(fn(shards, *args), os.path.join(out_dir, f"{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


class Ranks:
    """n ranks running ``fn(shards, *args)`` in new processes (``fn`` must
    be importable by name, its results picklable); ``join`` waits for them
    and returns their results, and raises if a rank failed."""

    def __init__(self, n: int, fn, args=(), device: str = "cpu",
                 threads: int = 1):
        self.n = n
        self._tmp = tempfile.mkdtemp(prefix="dealii_asm_tpu_torch_ranks_")
        try:
            self._ctx = mp.spawn(
                _rank_main, args=(n, os.path.join(self._tmp, "store"), fn,
                                  args, self._tmp, device, threads),
                nprocs=n, join=False)
        except BaseException:
            shutil.rmtree(self._tmp, ignore_errors=True)
            raise

    def join(self) -> list:
        try:
            while not self._ctx.join():
                pass
            return [torch.load(os.path.join(self._tmp, f"{r}.pt"),
                               map_location="cpu", weights_only=False)
                    for r in range(self.n)]
        finally:
            shutil.rmtree(self._tmp, ignore_errors=True)


def spawn(n: int, fn, args=(), device: str = "cpu", threads: int = 1):
    """[fn(shards, *args) for each of n ranks], run in n new processes
    (``Ranks`` joined at once)."""
    return Ranks(n, fn, args, device, threads).join()


# "replicate below" 1000 shards the 17^3 and 33^3 levels: a halo may not
# overlap itself (``halo.py::banded_stack``), which the 9^3 level's band of
# 4 planes would on 2 or 4 ranks
FLAGSHIP_SMALL = {
    "dim": 3, "degree": 4, "n refinements": 3,
    "solver": {"type": "CG", "rel tolerance": 1e-4},
    "preconditioner": {
        "type": "Multigrid", "mg type": "h", "replicate below": 1000,
        "mg smoother": {"type": "Chebyshev", "degree": 1,
                        "preconditioner": {"type": "FDM", "n overlap": 1,
                                           "weighting type": "symm"}},
        "mg coarse grid solver": {"type": "AMG"}},
}


def dryrun(shards: Shards) -> dict:
    """One sharded solver step and the small flagship solve on these
    shards; returns the rank's record: the step's norm and collective
    traffic (this rank's halo bytes sent; a degree-2 Chebyshev step applies
    the operator three times and the FDM twice), the solve's count and the
    whole solve's traffic (setup, warm-up and timed solve)."""
    from ..models.poisson import run_config

    step, x, b = sharded_solver_step(shards)
    shards.reset_traffic()
    y = step.step(x, b)
    step_traffic = dict(shards.traffic)
    y_full = step.sl.unpad(y)
    params = dict(FLAGSHIP_SMALL, **{"n devices": shards.world})
    shards.reset_traffic()
    res = run_config(params, log=lambda *_: None, device=shards.device,
                     shards=shards)
    ok = bool(torch.isfinite(y_full).all()) and res["converged"] and bool(
        torch.isfinite(res["solution"]).all())
    return {"ranks": shards.world, "device": str(shards.device),
            "step_norm": float(torch.linalg.vector_norm(y_full.double())),
            "step_traffic": step_traffic, "n_dofs": res["n_dofs"],
            "it": res["it"], "solve_traffic": dict(shards.traffic), "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dealii_asm_tpu_torch.parallel.dryrun")
    ap.add_argument("n", type=int, help="number of ranks")
    ap.add_argument("--device", default="cuda",
                    help="torch device type: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if launched_world_size() is not None:
        rec = dryrun(process_shards(args.n, args.device))
        if dist.get_rank() != 0:
            return 0 if rec["ok"] else 1
    else:
        if args.device.startswith("cuda") and not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch.cuda.is_available() "
                               "is False")
        rec = spawn(args.n, dryrun, device=args.device)[0]
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
