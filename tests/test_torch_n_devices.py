"""The port's "n devices" option (dealii_asm_tpu_torch.models.poisson).

"auto" resolves to the number of devices of the run's type, as the JAX
package takes its visible device count (``dealii_asm_tpu/models/poisson.py``
run_config): ``torch.cuda.device_count()`` on CUDA, 1 on the CPU.  One
device runs; more raise NotImplementedError (ROADMAP item 14).  On the CPU
the flagship at 2 refinements with "auto" takes the JAX package's count on
one device (4 iterations), with the solutions equal to rel-l2 1e-8 (the
contract of tests/test_torch_poisson.py).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu_torch.models import poisson
from dealii_asm_tpu_torch.models.poisson import n_devices, run_config

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


def test_auto_on_more_than_one_cuda_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        poisson._check_unported_options({"n devices": "auto"},
                                        torch.device("cuda"))


def test_auto_runs_on_the_cpu_with_the_jax_count():
    ref = jax_run_config(_flagship(2, 1), log=lambda *a: None)
    got = run_config(_flagship(2, "auto"), log=lambda *a: None, device="cpu")
    assert got["converged"] and ref["converged"]
    assert got["it"] == ref["it"] == 4
    x_ref = np.asarray(ref["solution"])
    rel = np.linalg.norm(got["solution"].numpy() - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-8
