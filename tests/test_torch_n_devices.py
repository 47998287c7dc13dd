"""The port's "n devices" option (dealii_asm_tpu_torch.models.poisson).

"auto" resolves to the world size of the run's process group (or of its
torchrun launch) and, without one, to the number of devices of the run's
type, as the JAX package takes its visible device count
(``dealii_asm_tpu/models/poisson.py`` run_config):
``torch.cuda.device_count()`` on CUDA, 1 on the CPU.  Several devices
without a process group raise with the torchrun command; on two gloo ranks
"auto" runs the sharded solve (``parallel/driver.py``).  On the CPU the
flagship at 2 refinements takes the JAX package's count on one device (4
iterations), on one process and on two ranks, with the solutions equal to
rel-l2 1e-8 (the contract of tests/test_torch_poisson.py).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import _torch_ranks
from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu_torch.models import poisson
from dealii_asm_tpu_torch.models.poisson import n_devices, run_config
from dealii_asm_tpu_torch.parallel.dryrun import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flagship(n_refinements, n_dev):
    with open(os.path.join(ROOT, "experiments", "e2e_aniso_q4.json")) as f:
        p = json.load(f)
    p["n refinements"] = n_refinements
    p["print timing"] = False
    p["solver"]["best of"] = 1
    p["n devices"] = n_dev
    return p


@pytest.mark.parametrize("value,device,count,want", [
    ("auto", "cpu", 0, 1), ("auto", "cpu", 4, 1), ("auto", "cuda", 1, 1),
    ("auto", "cuda", 4, 4), (1, "cuda", 4, 1), ("2", "cpu", 0, 2)])
def test_n_devices_resolves_auto_to_the_device_count(value, device, count,
                                                     want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert n_devices({"n devices": value}, torch.device(device)) == want


@functools.lru_cache(maxsize=None)
def _jax_flagship(n_refinements):
    ref = jax_run_config(_flagship(n_refinements, 1), log=lambda *a: None)
    return ref["it"], ref["converged"], np.asarray(ref["solution"])


def _rel(x, x_ref):
    return np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)


def test_auto_on_more_than_one_cuda_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        poisson._sharding(_flagship(2, "auto"), torch.device("cuda"), None)
    # under a process group "auto" is its world size: two gloo ranks
    params = _flagship(2, "auto")
    params["preconditioner"]["replicate below"] = 1000
    runs = spawn(2, _torch_ranks.run_configs, ([params],))
    it_ref, conv_ref, x_ref = _jax_flagship(2)
    for (it, converged, x, n_dofs), in runs:
        assert converged and conv_ref and it == it_ref == 4
        assert _rel(x, x_ref) < 1e-8


def test_auto_runs_on_the_cpu_with_the_jax_count():
    it_ref, conv_ref, x_ref = _jax_flagship(2)
    got = run_config(_flagship(2, "auto"), log=lambda *a: None, device="cpu")
    assert got["converged"] and conv_ref
    assert got["it"] == it_ref == 4
    assert _rel(got["solution"].numpy(), x_ref) < 1e-8
