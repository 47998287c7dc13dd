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

The vectors are zero on the Dirichlet boundary and are made on the device
one at a time, when the solve asks for one, so the mix holds no more than
one right-hand side beside the solver.  Two generators make them from the
same seeded amplitudes:

- ``RightHandSides``, on the GLL-node lattice of a box (x fastest), from 1D
  sine tables that are zero at both ends (a few small products);
- ``PointRightHandSides``, at (n, 3) unit-box points in any order, with a
  mask of the free DoFs: the same sum, evaluated point by point in chunks
  of ``CHUNK`` rows, and zero where the mask is false.  It keeps the
  points (three float64 values a DoF) and the mask on the device.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .reference.fe import node_coordinates

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


def amplitudes(spec: dict, seed: int, device, dtype=torch.float64):
    """(K, max_mode, max_mode, max_mode) amplitudes a[k, c, b, a] (z mode
    c, y mode b, x mode a) of the K right-hand sides, drawn from ``seed``."""
    K, kmax = int(spec["right_hand_sides"]), int(spec["max_mode"])
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    a = np.arange(1, kmax + 1)
    damp = (a[:, None, None] + a[None, :, None] + a[None, None, :]
            - 2.0) ** -float(spec["decay"])
    return torch.as_tensor(rng.standard_normal((K, kmax, kmax, kmax)) * damp,
                           dtype=dtype, device=device)


class RightHandSides:
    """The K right-hand sides of one run, drawn from ``seed``, on the node
    lattice of ``cells`` cells of degree ``degree``."""

    def __init__(self, spec: dict, seed: int, cells, degree: int,
                 device, dtype=torch.float64):
        self.amp = amplitudes(spec, seed, device, dtype)
        a = np.arange(1, int(spec["max_mode"]) + 1)
        self.sines = []  # per axis x, y, z: (kmax, N_d), zero at both ends
        for c in cells:
            x = node_coordinates(int(c), degree)
            s = np.sin(np.pi * a[:, None] * x[None, :])
            s[:, [0, -1]] = 0.0
            self.sines.append(torch.as_tensor(s, dtype=dtype, device=device))
        self.count = int(spec["right_hand_sides"])

    def __call__(self, k: int) -> torch.Tensor:
        """The (n,) right-hand side k, node lattice x fastest."""
        sx, sy, sz = self.sines
        t = torch.einsum("cba,by,ax->cyx", self.amp[k], sy, sx)
        return (sz.mT @ t.reshape(t.shape[0], -1)).reshape(-1)


class PointRightHandSides:
    """The K right-hand sides of one run, drawn from ``seed``, at the (n, 3)
    unit-box points ``unit``, zero where the (n,) bool ``free`` is false."""

    CHUNK = 1 << 18  # points a step of the evaluation

    def __init__(self, spec: dict, seed: int, unit, free, device,
                 dtype=torch.float64):
        self.amp = amplitudes(spec, seed, device, dtype)
        a = np.arange(1, int(spec["max_mode"]) + 1)
        self.waves = torch.as_tensor(np.pi * a, dtype=dtype, device=device)
        self.unit = torch.as_tensor(np.asarray(unit), dtype=dtype,
                                    device=device)
        self.free = torch.as_tensor(np.asarray(free, bool), device=device)
        self.count = int(spec["right_hand_sides"])

    def __call__(self, k: int) -> torch.Tensor:
        """The (n,) right-hand side k, in the order of the points."""
        amp = self.amp[k]
        kmax = amp.shape[0]
        by_x = amp.reshape(kmax * kmax, kmax).mT  # (a, c·b)
        out = torch.empty(self.unit.shape[0], dtype=amp.dtype,
                          device=amp.device)
        for s in range(0, out.numel(), self.CHUNK):
            u = self.unit[s:s + self.CHUNK]
            sx, sy, sz = (torch.sin(u[:, d, None] * self.waves)
                          for d in range(3))
            t = (sx @ by_x).reshape(-1, kmax, kmax)  # (m, c, b)
            out[s:s + self.CHUNK] = ((t * sy[:, None, :]).sum(-1)
                                     * sz).sum(-1)
        return torch.where(self.free, out, 0.0)
