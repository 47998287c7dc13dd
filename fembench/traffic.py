"""Right-hand sides of a traffic mix (one generator for every mix).

A mix is a JSON file under ``fembench/traffic/`` with

- ``right_hand_sides``: K, the number of distinct right-hand sides a run
  cycles through;
- ``max_mode``: the largest Fourier index per axis; each right-hand side is
  Σ a_abc sin(aπx̂) sin(bπŷ) sin(cπẑ) over 1 ≤ a, b, c ≤ max_mode at the DoF
  nodes, x̂ the node's coordinate in the unit box before any map, so every
  seed poses the same work on the same modes;
- ``decay``: the amplitudes a_abc are standard normal draws from the seed
  divided by (a + b + c − 2)^decay;
- ``callers``: the number of closed-loop callers (one: each solve starts
  when the last one has returned).

The vectors are zero on the Dirichlet boundary and are built on the device
from 1D tables (a few small products), one at a time, so the mix holds no
more than one right-hand side beside the solver.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .reference.fe import gll

ROOT = Path(__file__).resolve().parent


def load(name: str) -> dict:
    path = ROOT / "traffic" / f"{name}.json"
    with open(path) as f:
        spec = json.load(f)
    for key in ("right_hand_sides", "max_mode", "decay", "callers"):
        if key not in spec:
            raise ValueError(f"{path}: no {key!r}")
    if spec["callers"] != 1:
        raise ValueError(f"{path}: the generator drives one closed-loop caller")
    return spec


def node_coordinates(cells: int, degree: int) -> np.ndarray:
    """Unit-box coordinates of the GLL-node lattice along one axis."""
    nodes = gll(degree + 1)
    k = np.arange(cells * degree + 1)
    cell = np.minimum(k // degree, cells - 1)
    return (cell + nodes[k - cell * degree]) / cells


class RightHandSides:
    """The K right-hand sides of one run, drawn from ``seed``."""

    def __init__(self, spec: dict, seed: int, cells, degree: int,
                 device, dtype=torch.float64):
        K, kmax = int(spec["right_hand_sides"]), int(spec["max_mode"])
        rng = np.random.default_rng(int(seed) % 2 ** 64)
        a = np.arange(1, kmax + 1)
        damp = (a[:, None, None] + a[None, :, None] + a[None, None, :]
                - 2.0) ** -float(spec["decay"])
        # amp[k, c, b, a]: z mode c, y mode b, x mode a
        self.amp = torch.as_tensor(rng.standard_normal((K, kmax, kmax, kmax))
                                   * damp, dtype=dtype, device=device)
        self.sines = []  # per axis x, y, z: (kmax, N_d), zero at both ends
        for c in cells:
            x = node_coordinates(int(c), degree)
            s = np.sin(np.pi * a[:, None] * x[None, :])
            s[:, [0, -1]] = 0.0
            self.sines.append(torch.as_tensor(s, dtype=dtype, device=device))
        self.count = K

    def __call__(self, k: int) -> torch.Tensor:
        """The (n,) right-hand side k, node lattice x fastest."""
        sx, sy, sz = self.sines
        t = torch.einsum("cba,by,ax->cyx", self.amp[k], sy, sx)
        return (sz.mT @ t.reshape(t.shape[0], -1)).reshape(-1)
