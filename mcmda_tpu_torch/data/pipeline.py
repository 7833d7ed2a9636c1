"""On-device input pipeline (counterpart of ``mcmda_tpu/data/pipeline.py``).

Augmentation is a random flip + joint affine rotate / zoom / shift of the
(image, one-hot label) pair on the device, so the only host work per step
is, at most, an integer gather.  When the dataset fits the device it lives
there whole and each step samples its batch on the device.  A larger
dataset stays on the host: ``BatchSampler`` draws numpy batches and
``prefetch_to_device`` keeps two of them in flight to the device.

The per-image parameters ``(flip, theta, zoom, shift_y, shift_x)`` come from
``draw_params`` with a ``torch.Generator``, or are injected (``draws``):
JAX's threefry and torch's generators never agree, so tests hand both
packages the same draws.

``cfg.warp`` selects the warp: ``"pallas"`` is the affine warp of
``kernels/warp.py`` (the hand-written kernel on a CUDA tensor, its plain
version on the CPU); ``"xla"`` is the plain flip-then-warp of
``augment_pair``.  Both compute the same transform.
"""

from __future__ import annotations

import collections
import math
from typing import Iterator

import numpy as np
import torch

from mcmda_tpu_torch.config import DataConfig
from mcmda_tpu_torch.kernels import warp as warp_mod


# ---------------------------------------------------------------- transforms
def _affine_grid(h: int, w: int, theta, zoom, shift_y, shift_x):
    """Sampling coordinates [B,H,W] of the inverse affine map (rotate +
    zoom + shift about the image centre) for per-image draws [B]."""
    yy = torch.arange(h, dtype=torch.float32, device=theta.device)
    xx = torch.arange(w, dtype=torch.float32, device=theta.device)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y = (yy - cy)[None, :, None]
    x = (xx - cx)[None, None, :]
    cos, sin = (torch.cos(theta)[:, None, None],
                torch.sin(theta)[:, None, None])
    inv_scale = (1.0 / zoom)[:, None, None]
    ys = (cos * y - sin * x) * inv_scale + cy - shift_y[:, None, None]
    xs = (sin * y + cos * x) * inv_scale + cx - shift_x[:, None, None]
    return ys, xs


def _warp(img, ys, xs):
    """Bilinear warp of [B,H,W,C] at sampling coords [B,H,W]; out-of-range
    samples are 0.  The 4 corners are edge-clamped, as the JAX package's
    packed single gather clamps them."""
    b, h, w, _ = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    valid = ((ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1))[..., None]
    y0c = y0.clamp(0, h - 1).long()
    x0c = x0.clamp(0, w - 1).long()
    y1c = (y0c + 1).clamp_max(h - 1)
    x1c = (x0c + 1).clamp_max(w - 1)
    bi = torch.arange(b, device=img.device)[:, None, None]
    g00, g01 = img[bi, y0c, x0c], img[bi, y0c, x1c]
    g10, g11 = img[bi, y1c, x0c], img[bi, y1c, x1c]
    v = ((1 - wy) * (1 - wx) * g00 + (1 - wy) * wx * g01
         + wy * (1 - wx) * g10 + wy * wx * g11)
    return torch.where(valid, v, torch.zeros((), device=img.device))


def draw_params(gen: torch.Generator, cfg: DataConfig, batch: int, device):
    """Per-image draws [B,5] f32: (flip 0/1, theta, zoom, shift_y, shift_x)
    over the config's ranges (the ranges of the JAX ``_draw_params``)."""
    u = torch.rand((batch, 5), generator=gen, device=device)
    flip = ((u[:, 0] < 0.5) & cfg.flip).float()
    theta = (u[:, 1] * 2.0 - 1.0) * (cfg.rotate_degrees * math.pi / 180.0)
    lo, hi = cfg.zoom_range
    zoom = lo + (hi - lo) * u[:, 2]
    s = cfg.shift_pixels
    sy = -s + 2.0 * s * u[:, 3]
    sx = -s + 2.0 * s * u[:, 4]
    return torch.stack([flip, theta, zoom, sy, sx], -1)


def augment_pair(images, labels_onehot, draws):
    """Plain joint augmentation of a batch (the JAX ``augment_pair``, one
    image per row of ``draws``): flip, then warp, then renormalize the
    warped one-hot labels."""
    h, w = images.shape[1], images.shape[2]
    flip, theta, zoom, sy, sx = draws.unbind(-1)
    f = (flip > 0)[:, None, None, None]
    images = torch.where(f, images.flip(2), images)
    labels_onehot = torch.where(f, labels_onehot.flip(2), labels_onehot)
    ys, xs = _affine_grid(h, w, theta, zoom, sy, sx)
    ci = images.shape[-1]
    both = _warp(torch.cat([images, labels_onehot], -1), ys, xs)
    both = warp_mod.renormalize_labels(both, ci)
    return both[..., :ci], both[..., ci:]


def _kernel_warp(packed, draws, n_image: int):
    """The affine warp of ``kernels/warp.py`` with the flip folded into the
    coefficients."""
    h, w = packed.shape[1], packed.shape[2]
    flip, theta, zoom, sy, sx = draws.unbind(-1)
    coefs = warp_mod.affine_coefs(theta, zoom, sy, sx, flip, h, w)
    return warp_mod.warp_affine(packed.contiguous(), coefs, n_image=n_image)


def augment_batch(gen, images, labels_onehot, cfg: DataConfig, draws=None):
    """Joint augmentation of (images [B,H,W,C], one-hot labels [B,H,W,K])
    -> (images, labels), labels renormalized.  ``draws`` [B,5] overrides
    the generator's draws."""
    if draws is None:
        draws = draw_params(gen, cfg, images.shape[0], images.device)
    if cfg.warp != "pallas":
        return augment_pair(images, labels_onehot, draws)
    ci = images.shape[-1]
    both = _kernel_warp(torch.cat([images, labels_onehot], -1), draws, ci)
    return both[..., :ci], both[..., ci:]


def augment_images(gen, images, cfg: DataConfig, draws=None):
    """Image-only augmentation (the unlabeled target stream of adaptation):
    the same transforms, no label channels."""
    if draws is None:
        draws = draw_params(gen, cfg, images.shape[0], images.device)
    if cfg.warp == "pallas":
        return _kernel_warp(images, draws, images.shape[-1])
    return augment_pair(images, images[..., :0], draws)[0]


# ------------------------------------------------- device-resident datasets
def to_device_arrays(ds, num_classes: int | None = None, device="cuda"):
    """Put a SliceDataset on the device for on-device sampling: images f32,
    labels int8 (one-hot on the device at sampling time)."""
    out = {"images": torch.from_numpy(
        np.ascontiguousarray(ds.images, np.float32)).to(device)}
    if ds.labels is not None and num_classes:
        out["labels"] = torch.from_numpy(ds.labels.astype(np.int8)).to(device)
    return out


def sample_device_batch(data, gen: torch.Generator, batch_size: int,
                        num_classes: int | None = None):
    """Gather a uniform with-replacement batch from device-resident arrays
    by indices drawn from ``gen``."""
    images = data["images"]
    idx = torch.randint(0, images.shape[0], (batch_size,), generator=gen,
                        device=images.device)
    batch = {"image": images[idx]}
    if "labels" in data and num_classes:
        batch["label"] = torch.nn.functional.one_hot(
            data["labels"][idx].long(), num_classes).float()
    return batch


# --------------------------------------------------------------- host feed
class BatchSampler:
    """Host-side index sampler over a SliceDataset: uniform with-replacement
    batches, as numpy arrays."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_classes: int | None = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.num_classes = num_classes

    def __iter__(self) -> Iterator[dict]:
        n = len(self.ds)
        while True:
            idx = self.rng.integers(0, n, self.batch_size)
            batch = {"image": self.ds.images[idx]}
            if self.ds.labels is not None and self.num_classes:
                batch["label"] = np.eye(self.num_classes, dtype=np.float32)[
                    self.ds.labels[idx]]
            yield batch


# ----------------------------------------------------- host-side augmentation
def augment_batch_host(rng: np.random.Generator, images: np.ndarray,
                       labels_onehot: np.ndarray | None, cfg: DataConfig):
    """scipy-based joint augmentation on the HOST (numpy in, numpy out;
    copy of the JAX package's).  The transform family and the parameter
    ranges of ``augment_batch``; nothing on the main path calls it."""
    from scipy import ndimage as ndi

    out_i = np.empty_like(images)
    out_l = np.empty_like(labels_onehot) if labels_onehot is not None else None
    h, w = images.shape[1:3]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    for b in range(images.shape[0]):
        flip = cfg.flip and rng.random() < 0.5
        theta = rng.uniform(-1, 1) * np.deg2rad(cfg.rotate_degrees)
        zoom = rng.uniform(*cfg.zoom_range)
        sy = rng.uniform(-cfg.shift_pixels, cfg.shift_pixels)
        sx = rng.uniform(-cfg.shift_pixels, cfg.shift_pixels)
        cos, sin = np.cos(theta), np.sin(theta)
        mat = np.array([[cos, -sin], [sin, cos]]) / zoom
        offset = np.array([cy - sy, cx - sx]) - mat @ np.array([cy, cx])

        def warp(img2d, order):
            return ndi.affine_transform(img2d, mat, offset=offset, order=order,
                                        mode="constant", cval=0.0)

        im = images[b, :, ::-1] if flip else images[b]
        out_i[b] = np.stack([warp(im[..., c], 1)
                             for c in range(im.shape[-1])], -1)
        if out_l is not None:
            lb = labels_onehot[b, :, ::-1] if flip else labels_onehot[b]
            wl = np.stack([warp(lb[..., c], 1) for c in range(lb.shape[-1])],
                          -1)
            out_l[b] = wl / np.maximum(wl.sum(-1, keepdims=True), 1e-6)
    return out_i, out_l


def host_augmented(stream: Iterator, cfg: DataConfig, seed: int = 0,
                   keys=("image",), label_key: str | None = "label") -> Iterator:
    """Wrap a batch stream with host-side augmentation (copy of the JAX
    package's).  ``keys`` are image arrays to augment independently;
    ``label_key`` (if present in the batch) is warped jointly with
    "image"."""
    rng = np.random.default_rng(seed)
    for batch in stream:
        out = dict(batch)
        for k in keys:
            if k == "image" and label_key and label_key in batch:
                out[k], out[label_key] = augment_batch_host(
                    rng, batch[k], batch[label_key], cfg)
            elif k in batch:
                out[k], _ = augment_batch_host(rng, batch[k], None, cfg)
        yield out


# ------------------------------------------------------ host-to-device feed
class _PinnedStager:
    """Host-to-GPU copies of numpy batches that overlap the consumer's
    work: each batch is staged in pinned host memory and copied with
    ``non_blocking=True`` on a side stream.

    ``put`` returns (tensors, event of the copy); ``take`` makes the
    consumer's current stream wait on that event and marks the tensors as
    used on it, so the caching allocator does not hand their memory (it
    belongs to the side stream) to a later copy while a kernel still reads
    it.  The pinned buffers form a ring of ``slots`` batches, sized on the
    first batch; a slot is rewritten only after the copy that last read it
    has finished."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.ring = [{} for _ in range(slots)]
        self.done = [None] * slots
        self.n = 0

    def put(self, batch: dict):
        slot = self.n % len(self.ring)
        self.n += 1
        if self.done[slot] is not None:
            self.done[slot].synchronize()
        staged = self.ring[slot]
        out = {}
        for k, v in batch.items():
            src = torch.from_numpy(np.asarray(v))
            if k not in staged or staged[k].shape != src.shape:
                staged[k] = torch.empty(src.shape, dtype=torch.float32,
                                        pin_memory=True)
            staged[k].copy_(src)
        with torch.cuda.stream(self.stream):
            for k in batch:
                out[k] = staged[k].to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.done[slot] = event
        return out, event

    def take(self, item) -> dict:
        out, event = item
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in out.values():
            t.record_stream(current)
        return out


def prefetch_to_device(iterator: Iterator[dict], size: int = 2,
                       device="cuda") -> Iterator[dict]:
    """Double-buffered device feed: numpy batches in, f32 tensors on
    ``device`` out, in order, with ``size`` batches in flight so that the
    host's gather and the copy overlap the step before.  On a GPU the
    copies go through pinned memory on a side stream (``_PinnedStager``);
    on the CPU it is a plain conversion in the same queue order."""
    device = torch.device(device)
    queue: collections.deque = collections.deque()
    if device.type == "cuda":
        stager = _PinnedStager(device, max(1, size))
        put, take = stager.put, stager.take
    else:
        def put(batch):
            return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                    for k, v in batch.items()}

        def take(item):
            return item

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= size:
            yield take(queue.popleft())
    while queue:
        yield take(queue.popleft())
