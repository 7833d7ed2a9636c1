"""The device an entry point runs on, and the precision pins that go with
a GPU.

Every entry point (the four CLI commands, the four API functions, the
smoke script) calls ``resolve`` once.  On a GPU it pins f32 convs and
matmuls to full f32 (cuDNN and cuBLAS would otherwise run them in TF32,
and the adversarial path is precision-sensitive) and, for the training
entry points, cuDNN to deterministic algorithms, so that a seeded run
repeats bit for bit.  It returns the device asked for and never another: a
missing GPU is an error.
"""

from __future__ import annotations

import torch


def resolve(name="cuda", deterministic: bool = False) -> torch.device:
    """``torch.device(name)`` with the pins set when it is a GPU.  Raises
    ``RuntimeError`` when a GPU is asked for and there is none.  On the CPU
    no backend flag is touched."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!s}: no CUDA device available (ask for "
                "\"cpu\" to run the plain PyTorch versions on the CPU)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if deterministic:
            torch.backends.cudnn.deterministic = True
    return device


def settings() -> dict:
    """The pins as they stand, for a script to record beside its numbers."""
    return {"tf32": bool(torch.backends.cudnn.allow_tf32
                         or torch.backends.cuda.matmul.allow_tf32),
            "cudnn_deterministic": bool(torch.backends.cudnn.deterministic)}


def card() -> str | None:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, for a
    script to record beside its numbers; None without ``nvidia-smi``."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None
