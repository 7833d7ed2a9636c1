"""Per-slice inference -> 3D label volumes.

Counterpart of ``mcmda_tpu/evaluation/inference.py``.  The raw [S,H,W]
volume goes to the device once; context stacking is a clamped index gather
on the device (pad rows repeat the last slice's stack, as in the JAX
package), the forward and the argmax run batch by batch on the device, and
the label volume is read back once.  By default (``single_dispatch``) the
whole volume is one CUDA graph on a GPU, cached per forward and volume
shape: the counterpart of the JAX package's one jitted scan per volume.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmda_tpu_torch.data import volumes as vol_io
from mcmda_tpu_torch.parallel import dp
from mcmda_tpu_torch.train import drivers
from mcmda_tpu_torch.utils import cuda_graph, profiling

_scan_cache: dict = {}
_tta_cache: dict = {}
_shard_cache: dict = {}
_SCAN_CACHE_MAX = 32  # LRU bound: a long-lived serving process must not
# keep one graph (and the forward and weights it holds) per key forever


def _lru(cache: dict, key, make):
    """``cache[key]``, made by ``make()`` on a miss, moved to the most
    recently used end; beyond ``_SCAN_CACHE_MAX`` entries the least
    recently used one is evicted.  Keys hold their forward objects (not
    their ``id``), so a recycled id never finds a stale entry."""
    value = cache.pop(key, None)
    if value is None:
        value = make()
        while len(cache) >= _SCAN_CACHE_MAX:
            del cache[next(iter(cache))]
    cache[key] = value
    return value


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


def _argmax_volume(forward, vol, fwd_args, context: int, batch_size: int,
                   batches: int | None = None):
    """The int32 label volume [S,H,W] of the [S,H,W] device volume ``vol``:
    the context gather, then ``forward`` and the argmax batch by batch
    (only the first ``batches`` of them, a warm-up, when given)."""
    s = vol.shape[0]
    idx = _stack_index(s, context, batch_size, vol.device)
    stop = idx.shape[0] if batches is None else batches * batch_size
    preds = []
    for i in range(0, stop, batch_size):
        xb = vol[idx[i:i + batch_size]].permute(0, 2, 3, 1).contiguous()
        preds.append(torch.argmax(forward(xb, *fwd_args),
                                  dim=-1).to(torch.int32))
    return torch.cat(preds)[:s]


def _scanned_argmax(forward, shape_key, context: int, batch_size: int):
    """The runner ``(volume [S,H,W] f32 host tensor, *fwd_args) -> int32
    labels [S,H,W] on the device`` of the JAX package's jitted scan: one
    CUDA graph of the whole volume (the upload into its static buffer, the
    gather and pad rows, every batch's forward and argmax) where
    ``shape_key`` = (volume shape, device, graph?) says so, else the same
    function run eagerly.  Cached per (forward object, shape_key, context,
    batch) in an LRU of ``_SCAN_CACHE_MAX`` entries."""
    def make():
        _, device, graph = shape_key

        def run(vol, *fwd_args):
            return _argmax_volume(forward, vol, fwd_args, context,
                                  batch_size)

        def warm_up(vol, *fwd_args):
            return _argmax_volume(forward, vol, fwd_args, context,
                                  batch_size, batches=1)

        return cuda_graph.call(run, warm_up, device, graph)

    return _lru(_scan_cache, (forward, shape_key, context, batch_size), make)


def tta_flip(forward):
    """Test-time augmentation: average class probabilities over the
    horizontal flip (W axis of [B,H,W,ctx] inputs), run as ONE double-batch
    forward of the original and flipped slices; ``forward``'s extra
    arguments pass through.  Memoized per forward object, so that the
    serving graphs cached per forward stay warm across volumes."""
    def make():
        def f(xb, *fwd_args):
            b = xb.shape[0]
            p2 = forward(torch.cat([xb, xb.flip(2)]), *fwd_args)
            return 0.5 * (p2[:b] + p2[b:].flip(2))
        return f

    return _lru(_tta_cache, forward, make)


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
    which takes the images last); cached per (forward, group), so that a
    sharded volume keeps its graph across calls."""
    def make():
        fwd = dp.data_parallel_forward(lambda *a: forward(a[-1], *a[:-1]),
                                       group)
        return lambda xb, *args: fwd(*args, xb)

    return _lru(_shard_cache, (forward, group), make)


@torch.inference_mode()
def predict_volume(forward, volume: np.ndarray, *, context: int = 3,
                   batch_size: int = 8, single_dispatch: bool = True,
                   fwd_args=(), device="cuda", mesh=None) -> np.ndarray:
    """Run ``forward(images[B,H,W,ctx], *fwd_args) -> probs[B,H,W,K]`` over
    every slice of the [S,H,W] ``volume``; returns the label volume
    [S,H,W] int32.  ``fwd_args`` carries what changes between calls (the
    weights of a periodic validation) so that ``forward`` itself can stay
    one function, with one graph.

    ``single_dispatch`` (default): the volume is one call of
    ``_scanned_argmax``'s runner, a CUDA graph on a GPU alone or with an
    NCCL ``mesh`` (``drivers.dispatch``), eager on the CPU or over gloo.
    ``single_dispatch=False`` runs the batches eagerly one by one (the
    oracle the graph is held to).

    ``mesh``: a process group whose every rank calls this with the same
    volume; each batch is split over its ranks and the probabilities are
    gathered, so every rank returns the whole label volume.  ``batch_size``
    must divide by the number of ranks.

    On a GPU the host waits for the volume's device work in a span
    ``predict.wait``; the copy of the labels to the host is the span
    ``predict.readback`` (``profiling.span``)."""
    if mesh is not None:
        forward = _sharded(forward, mesh)
    vol = torch.from_numpy(np.ascontiguousarray(volume, np.float32))
    device = torch.device(device)
    if single_dispatch:
        graph = drivers.dispatch(device, mesh) == "graph"
        run = _scanned_argmax(forward, (tuple(vol.shape), device, graph),
                              context, batch_size)
        preds = run(vol, *fwd_args)
    else:
        preds = _argmax_volume(forward, vol.to(device), fwd_args, context,
                               batch_size)
    if preds.is_cuda:
        with profiling.span("predict.wait"):
            torch.cuda.current_stream(preds.device).synchronize()
    with profiling.span("predict.readback"):
        return preds.cpu().numpy()


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
