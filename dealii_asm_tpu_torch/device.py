"""Device and dtype policy of the port.

The outer Krylov solve runs in float64, the multigrid levels in float32
(``OUTER_DTYPE``, ``LEVEL_DTYPE``), on ``DEFAULT_DEVICE`` unless the caller
passes ``device="cpu"``; without a GPU that default raises.  TF32 stays
off: operator noise on the level A-path costs outer iterations (measured in
the JAX package: 8 instead of 5 at 2.1M DoFs), so every constructor applies
the policy through ``resolve_device`` and ``run_config`` checks it with
``assert_no_tf32``.
"""

from __future__ import annotations

import torch

OUTER_DTYPE = torch.float64
LEVEL_DTYPE = torch.float32
# every entry point runs on the card unless the caller asks for the CPU
DEFAULT_DEVICE = "cuda"
# the dtypes the CUDA kernels are instantiated for; a bfloat16 level runs
# plain torch, as the JAX package runs XLA where its kernels need float32
KERNEL_DTYPES = (torch.float32, torch.float64)


def apply_precision_policy() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def assert_no_tf32() -> None:
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is enabled; the port's A-path needs true "
                           "float32 (see dealii_asm_tpu_torch/device.py)")


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested, but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    apply_precision_policy()
    return dev


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
