"""Two dependent operator sweeps, dispatched apart or as one program
(PyTorch): the reference's ``power_kernel_01.likwid.cc``.

Counterpart of ``dealii_asm_tpu/models/power_kernel.py`` (:25-65).  The
reference fuses a vmult with a follow-up cell pass; the JAX package asks
whether XLA fuses two dependent grid sweeps inside one jit.  On the card
the question is what one captured program saves against eager dispatch:

    sequential     : two eager applies, dst = A·(A·u), with a
                     ``torch.cuda.synchronize`` between them
    power-own      : one CUDA-graph replay of A·(A·u)
    power-own-axpy : one CUDA-graph replay of A·(A·u) + 0.5·u

on the balanced periodic box (float32).  Periodic meshes take the plain
banded operator: kernels A–E refuse them, as the JAX kernels do.  On the
CPU all three labels run eagerly.  A ``#`` line names the mode, then one
``>> label n_dofs 2·n_rep seconds 4 degree 0 0`` line per label.

    python -m dealii_asm_tpu_torch.models.power_kernel [cfg.json ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, synchronize
from ..fem.dofs import DofHandler
from ..mesh.balanced import balanced_hyper_cube_subdivisions
from ..mesh.grid import StructuredMesh
from ..ops.laplace import LaplaceOperator
from ..utils.config import get_param


def captured(fn, x: torch.Tensor):
    """y ↦ fn(y) as one CUDA-graph replay on static buffers: the input is
    copied into the graph's input and the graph's output returned (valid
    until the next call)."""
    static_in = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(static_in)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fn(static_in)

    def replay(y):
        static_in.copy_(y)
        graph.replay()
        return static_out
    return replay


def run_power_kernel(params: dict, out=None, device=DEFAULT_DEVICE,
                     on_label=None) -> int:
    """Print the three labels' lines to ``out`` (standard output by
    default); returns the DoF count.  ``on_label(label, fn, u)`` is
    called after each label's timed chain."""
    device = resolve_device(device)
    out = sys.stdout if out is None else out
    dim = int(get_param(params, "dim", 3))
    s = int(get_param(params, "n subdivision", 6))
    degree = int(get_param(params, "fe degree", 4))
    n_rep = int(get_param(params, "n repetitions", 10))
    cells, lengths = balanced_hyper_cube_subdivisions(dim, s)
    mesh = StructuredMesh(dim, tuple(cells), lengths=tuple(lengths),
                          periodic=(True,) * dim)
    dofs = DofHandler(mesh, degree)
    op = LaplaceOperator(dofs, dtype=torch.float32, device=device)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        dofs.n_dofs)).to(device=device, dtype=torch.float32)

    def sequential(v):
        w = op.vmult(v)
        synchronize(device)
        return op.vmult(w)

    def power(v):
        return op.vmult(op.vmult(v))

    def power_axpy(v):
        return op.vmult(op.vmult(v)) + 0.5 * v

    graphs = device.type == "cuda"
    print("# power kernel: " + ("sequential eager, power-own(-axpy) one "
                                "CUDA-graph replay" if graphs else
                                "all labels eager (no CUDA graphs on the "
                                f"{device.type})"), file=out, flush=True)
    for label, fn in (("sequential", sequential), ("power-own", power),
                      ("power-own-axpy", power_axpy)):
        if graphs and label != "sequential":
            fn = captured(fn, u)
        y = fn(u)
        synchronize(device)
        t0 = time.perf_counter()
        y = u
        for _ in range(n_rep):
            y = fn(y)
        synchronize(device)
        dt = time.perf_counter() - t0
        print(f">> {label} {dofs.n_dofs} {2 * n_rep} {dt:.6g} 4 {degree} 0 0",
              file=out, flush=True)
        if on_label is not None:
            on_label(label, fn, u)
    return dofs.n_dofs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dealii_asm_tpu_torch.models.power_kernel")
    ap.add_argument("configs", nargs="*", help="JSON config files")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    for path in args.configs or [None]:
        params = {}
        if path:
            with open(path) as f:
                params = json.load(f)
        run_power_kernel(params, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
