"""Per-slice inference -> 3D label volumes.

Counterpart of ``mcmda_tpu/evaluation/inference.py``.  The raw [S,H,W]
volume goes to the device once; context stacking is a clamped index gather
on the device (pad rows repeat the last slice's stack, as in the JAX
package), the forward runs batch by batch, the argmax stays on the device,
and the label volume is read back once.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmda_tpu_torch.data import volumes as vol_io
from mcmda_tpu_torch.parallel import dp


def _stack_index(s: int, context: int, batch_size: int, device):
    """[S+pad, context] slice indices: each row is a slice's clamped
    neighbourhood; pad rows (up to a multiple of ``batch_size``) repeat the
    last slice."""
    if context % 2 != 1:
        raise ValueError(f"context must be odd, got {context}")
    half = context // 2
    pad = (-s) % batch_size
    base = torch.cat([torch.arange(s, device=device),
                      torch.full((pad,), s - 1, device=device)])
    offs = torch.arange(-half, half + 1, device=device)
    return torch.clamp(base[:, None] + offs[None, :], 0, s - 1)


def tta_flip(forward):
    """Test-time augmentation: average class probabilities over the
    horizontal flip (W axis of [B,H,W,ctx] inputs), run as ONE double-batch
    forward of the original and flipped slices."""
    def f(xb):
        b = xb.shape[0]
        p2 = forward(torch.cat([xb, xb.flip(2)]))
        return 0.5 * (p2[:b] + p2[b:].flip(2))
    return f


def get_tta(name: str | None):
    """Resolve a TTA mode name to a forward wrapper (None for "none")."""
    if name in (None, "", "none"):
        return None
    if name == "flip":
        return tta_flip
    raise ValueError(f"unknown TTA mode {name!r} (expected none|flip)")


def _sharded(forward, group):
    """``forward(images, *fwd_args)`` with each batch split over the ranks
    of ``group`` and the outputs gathered (``dp.data_parallel_forward``,
    which takes the images last)."""
    fwd = dp.data_parallel_forward(lambda *a: forward(a[-1], *a[:-1]), group)
    return lambda xb, *args: fwd(*args, xb)


@torch.inference_mode()
def predict_volume(forward, volume: np.ndarray, *, context: int = 3,
                   batch_size: int = 8, fwd_args=(), device="cuda",
                   mesh=None) -> np.ndarray:
    """Run ``forward(images[B,H,W,ctx], *fwd_args) -> probs[B,H,W,K]`` over
    every slice of the [S,H,W] ``volume``; returns the label volume
    [S,H,W] int32.  ``fwd_args`` carries what changes between calls (the
    weights of a periodic validation) so that ``forward`` itself can stay
    one function.

    ``mesh``: a process group whose every rank calls this with the same
    volume; each batch is split over its ranks and the probabilities are
    gathered, so every rank returns the whole label volume.  ``batch_size``
    must divide by the number of ranks."""
    if mesh is not None:
        forward = _sharded(forward, mesh)
    s = volume.shape[0]
    vol = torch.from_numpy(np.ascontiguousarray(volume, np.float32)).to(device)
    idx = _stack_index(s, context, batch_size, device)
    preds = []
    for i in range(0, idx.shape[0], batch_size):
        xb = vol[idx[i:i + batch_size]].permute(0, 2, 3, 1).contiguous()
        preds.append(torch.argmax(forward(xb, *fwd_args), dim=-1))
    return torch.cat(preds)[:s].to(torch.int32).cpu().numpy()


@torch.inference_mode()
def predict_volume_probs(forward, volume: np.ndarray, *, context: int = 3,
                         batch_size: int = 8, device="cuda") -> np.ndarray:
    """Same, but returns the full softmax volume [S,H,W,K] (parity checks);
    stacks the context on the host like the JAX package's version."""
    stacked = vol_io.stack_context(volume, context)
    s = stacked.shape[0]
    pad = (-s) % batch_size
    if pad:
        stacked = np.concatenate([stacked, np.repeat(stacked[-1:], pad, 0)], 0)
    x = torch.from_numpy(np.ascontiguousarray(stacked, np.float32))
    out = [forward(x[i:i + batch_size].to(device)).float().cpu()
           for i in range(0, x.shape[0], batch_size)]
    return torch.cat(out)[:s].numpy()
