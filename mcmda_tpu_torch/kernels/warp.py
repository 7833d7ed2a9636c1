"""Bilinear affine warp of a packed image + one-hot label batch.

Counterpart of ``mcmda_tpu/kernels/warp.py``.  The augmentation's flip,
rotation, zoom and shift about the image centre are one affine inverse map
per image, ``ys = c0*y + c1*x + c2``, ``xs = c3*y + c4*x + c5``, with the
flip folded into the x row (``affine_coefs``).  Every output pixel is the
4-corner bilinear sample of the input at (ys, xs), 0 outside the image, and
the label channels (index >= ``n_image``) are renormalised to sum to 1.

- ``warp_affine_reference``: the plain PyTorch version, the oracle.
- ``warp_affine``: the wrapper the pipeline calls.  A CPU tensor takes the
  plain version; a CUDA tensor launches the hand-written kernel
  (``csrc/warp.cu``) or raises.  There is no silent fallback.  The kernel
  rounds every product and sum of the coordinates and of the blend as the
  plain version's tensor operations do, so its image channels are bitwise
  the plain version's; the renormalised label channels agree to 1e-5 (the
  label sum's order may differ).

The TPU kernel's banded-matmul form and its sizing helpers (``band_bound``,
``tile_width``) exist because a TPU has no fast gather; they are not
ported.  Its bf16 MXU payload is not either: both versions here are f32.
"""

from __future__ import annotations

import torch

from mcmda_tpu_torch.kernels import build

# Kernel launches made by ``warp_affine``; callers reset and read it to show
# that a run really went through the kernel.
LAUNCHES = 0


def affine_coefs(theta, zoom, shift_y, shift_x, flip, h: int, w: int):
    """Coefficients [B,6] f32 (ay, by, cy, ax, bx, cx) of the inverse map
    of ``pipeline._affine_grid`` for per-image draws [B] (``flip`` 0 or 1),
    with a horizontal flip folded into the x row: sampling the flipped image
    at xs equals sampling the original at w-1-xs."""
    cy_c, cx_c = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    inv = 1.0 / zoom
    ay, by = cos * inv, -sin * inv
    c_y = -ay * cy_c - by * cx_c + cy_c - shift_y
    ax, bx = sin * inv, cos * inv
    c_x = -ax * cy_c - bx * cx_c + cx_c - shift_x
    flip = flip.float()
    sign = 1.0 - 2.0 * flip  # +1 normal, -1 flipped
    ax, bx = ax * sign, bx * sign
    c_x = c_x * sign + flip * (w - 1)
    return torch.stack([ay, by, c_y, ax, bx, c_x], -1).float()


def sample_coords(coefs, h: int, w: int):
    """(ys, xs) [B,H,W] of the inverse map, each tensor op rounding to f32
    in the order the kernel reproduces: ``(c0*y + c1*x) + c2``."""
    yy = torch.arange(h, dtype=torch.float32, device=coefs.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=coefs.device)[None, :]
    c = coefs[:, :, None, None]
    ys = c[:, 0] * yy + c[:, 1] * xx + c[:, 2]
    xs = c[:, 3] * yy + c[:, 4] * xx + c[:, 5]
    return ys, xs


def renormalize_labels(out, n_image: int):
    """Divide the channels from ``n_image`` on by max(their sum, 1e-6): a
    warped one-hot label stays a distribution (argmax = nearest class)."""
    if n_image >= out.shape[-1]:
        return out
    lab = out[..., n_image:]
    lab = lab / torch.clamp_min(lab.sum(-1, keepdim=True), 1e-6)
    return torch.cat([out[..., :n_image], lab], -1)


def warp_affine_reference(images, coefs, n_image: int | None = None):
    """Plain PyTorch version: images [B,H,W,C] f32, coefs [B,6] -> warped
    [B,H,W,C] f32, channels >= ``n_image`` (default C: none) renormalised."""
    from mcmda_tpu_torch.data.pipeline import _warp

    h, w, c = images.shape[1:]
    ys, xs = sample_coords(coefs, h, w)
    out = _warp(images.float(), ys, xs)
    return renormalize_labels(out, c if n_image is None else n_image)


def warp_affine(images, coefs, n_image: int | None = None):
    """images [B,H,W,C] f32, coefs [B,6] f32 -> f32 [B,H,W,C], channels
    >= ``n_image`` renormalised.  CPU tensors: the plain version; CUDA
    tensors: the kernel."""
    if images.device.type == "cpu":
        return warp_affine_reference(images, coefs, n_image)
    if images.device.type != "cuda":
        raise ValueError(f"warp_affine: no kernel for device {images.device}")
    if images.dim() != 4:
        raise ValueError(f"images must be [B,H,W,C], got "
                         f"{tuple(images.shape)}")
    b, h, w, c = images.shape
    n_image = c if n_image is None else n_image
    if not 0 <= n_image <= c:
        raise ValueError(f"n_image {n_image} not in [0, {c}]")
    f32 = (torch.float32,)
    build.check("images", images, (b, h, w, c), f32, images.device)
    build.check("coefs", coefs, (b, 6), f32, images.device)
    if b * h * w >= 2 ** 31 or b > 65535:
        raise ValueError("warp_affine: B*H*W must fit a 32-bit int and B "
                         "(a grid dimension) be at most 65535")

    out = torch.empty_like(images)
    build.launch("mcmda_warp_affine", images.device, images.data_ptr(),
                 coefs.data_ptr(), out.data_ptr(), b, h, w, c, n_image)
    global LAUNCHES
    LAUNCHES += 1
    return out
