"""The host side of ``csrc/conv_tile.cuh``: which main loop a conv call
takes, and the Hopper loop's weight pre-split.

Both conv kernels (``fused_conv``, ``train_conv``) run one of two loops,
chosen by shape in one place, ``conv_tile::plan`` in the header:

- the Hopper loop (TMA + ``wgmma``) for f32 x with C a multiple of 32, K a
  multiple of 64 and 128-pixel tiles that are whole image rows (W divides
  128 and 128 / W divides H) or whole parts of one row (128 divides W):
  every 1/8-resolution tail site and rm2 / rm3's f32 sites;
- the ``mma.sync`` loop for every other shape (the C = 3 stem, K <= 32,
  bf16 x, ragged tiles).

``plan`` mirrors that function so that a test without a card can walk
every call site; the library's own answer is ``plan_on_device``
(``mcmda_conv_plan``), which the wrappers use and the card's tests hold
against ``plan``.  The Hopper loop reads the weights K-major and split into
TF32 hi / lo parts, written each call by a pre-pass kernel into scratch
that the wrapper allocates (``weight_scratch``); ``split_weights`` runs
that pre-pass alone (for tests and timing; the conv wrappers run it inside
their own launch), ``split_weights_reference`` is its plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from mcmda_tpu_torch.kernels import build

BM = 128  # pixels per block (both loops)
BK = 32  # channels per Hopper step: one 128-byte row of f32
MMA_SYNC_WIDTHS = (16, 32, 64, 128)  # the mma.sync loop's tile widths
H100_SMS = 132
LOOPS = ("mma_sync", "wgmma")

# Launches made by ``split_weights`` (not the pre-passes that the conv
# wrappers run inside their own launches)
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """A conv call's loop, output channels per block, the Hopper loop's
    A box as (image rows, columns) (None on the mma.sync loop) and grid
    (pixel tiles, channel tiles)."""

    loop: str
    bn: int
    box: tuple[int, int] | None
    grid: tuple[int, int]


def plan(n: int, h: int, w: int, c: int, k: int,
         x_dtype: torch.dtype = torch.float32, sms: int = H100_SMS) -> Plan:
    """``conv_tile::plan`` for x [n, h, w, c] of ``x_dtype`` to k channels
    on a card of ``sms`` SMs."""
    m = n * h * w
    rows_fit = (BM % w == 0 and h % (BM // w) == 0) or w % BM == 0
    if x_dtype == torch.float32 and c % BK == 0 and k % 64 == 0 and rows_fit:
        box_w = min(w, BM)
        # 128 wide unless that fills under 3/4 of the SMs
        blocks128 = (m // BM) * (k // 128)
        bn = 128 if k % 128 == 0 and 4 * blocks128 >= 3 * sms else 64
        return Plan("wgmma", bn, (BM // box_w, box_w), (m // BM, k // bn))
    if k <= 64:
        bn = next(b for b in MMA_SYNC_WIDTHS if k <= b)
    else:
        bn = 128 if -(-m // BM) * -(-k // 128) >= sms else 64
    return Plan("mma_sync", bn, None, (-(-m // BM), -(-k // bn)))


@functools.lru_cache(maxsize=512)
def _library_plan(n, h, w, c, k, x_bf16, sms) -> Plan:
    out = (ctypes.c_int * 6)()
    build.load().mcmda_conv_plan(n, h, w, c, k, x_bf16, sms, out)
    loop, bn, box_h, box_w, gx, gy = out
    return Plan(LOOPS[loop], bn, (box_h, box_w) if box_h else None, (gx, gy))


def plan_on_device(n: int, h: int, w: int, c: int, k: int,
                   x_dtype: torch.dtype, device) -> Plan:
    """The plan the library gives this call on ``device`` (a CUDA device):
    what the kernel will run."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _library_plan(n, h, w, c, k, int(x_dtype == torch.bfloat16), sms)


def tensor_maps(n: int, h: int, w: int, c: int, k: int, p: Plan):
    """The Hopper loop's TMA tensor maps as ``hopper::make_maps`` encodes
    them: {name: (dims, byte strides of dims 1.., box)}, dims and box
    innermost first; f32 elements, 128-byte swizzle."""
    if p.loop != "wgmma":
        raise ValueError(f"the {p.loop} loop has no tensor maps")
    row = 4 * c
    box_h, box_w = p.box
    weights = ((9 * c, k), (36 * c,), (BK, p.bn))
    return {"x": ((c, w, h, n), (row, row * w, row * w * h),
                  (BK, box_w, box_h, 1)),
            "w_hi": weights, "w_lo": weights}


def weight_scratch(p: Plan, c: int, k: int, device):
    """(w_hi, w_lo): the pre-pass's two f32 [k, 9c] outputs where the plan
    is the Hopper loop, else (None, None)."""
    if p.loop != "wgmma":
        return None, None
    return _split_pair(c, k, device)


def _split_pair(c, k, device):
    return tuple(torch.empty((k, 9 * c), dtype=torch.float32, device=device)
                 for _ in range(2))


def _tf32_bits(bits):
    return torch.bitwise_and(bits, -0x2000)  # clear the low 13 bits


def split_weights_reference(w):
    """HWIO f32 w [3, 3, C, K] -> (hi, lo), each f32 [K, 9C]: the weights
    seen as [9C, K], transposed, and split as ``split_tf32`` splits them:
    hi = w rounded to TF32 (nearest, ties away from zero, as cvt.rna: add
    half of the dropped 13 bits, then clear them), lo = w - hi (exact in
    f32) truncated to TF32; |w - hi - lo| <= 2^-21 |w|."""
    wt = w.reshape(-1, w.shape[-1]).t().contiguous()
    hi = _tf32_bits(wt.view(torch.int32) + 0x1000).view(torch.float32)
    lo = _tf32_bits((wt - hi).view(torch.int32)).view(torch.float32)
    return hi, lo


def split_weights(w):
    """The pre-pass alone: HWIO f32 w [3, 3, C, K] -> (hi, lo) f32 [K, 9C].
    CPU tensors: the plain version; CUDA tensors: the kernel."""
    if w.device.type == "cpu":
        return split_weights_reference(w)
    if w.device.type != "cuda":
        raise ValueError(f"split_weights: no kernel for device {w.device}")
    if w.dim() != 4 or w.shape[:2] != (3, 3):
        raise ValueError(f"w must be [3,3,C,K], got {tuple(w.shape)}")
    c, k = w.shape[2], w.shape[3]
    build.check("w", w, (3, 3, c, k), (torch.float32,), w.device)
    hi, lo = _split_pair(c, k, w.device)
    build.launch("mcmda_split_weights", w.device, w.data_ptr(),
                 hi.data_ptr(), lo.data_ptr(), c, k)
    global LAUNCHES
    LAUNCHES += 1
    return hi, lo
