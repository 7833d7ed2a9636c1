"""Volume IO and normalization (host-side numpy).

A copy of ``mcmda_tpu/data/volumes.py``: NIfTI-1/-2 and npz/npy volumes
in and out, per-volume normalization, context stacking and the slice
dataset the training feeds draw from.  Copied rather than imported because importing any module of the
JAX package imports ``jax``.  A minimal NIfTI reader and writer are
implemented here (gzip-aware, scl_slope/scl_inter honoring), so no NIfTI
library is needed.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

# ------------------------------------------------------------- NIfTI-1 / -2
_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}


def _read_file(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _parse_nifti_header(hdr: bytes, path: str) -> dict:
    """Parse a NIfTI-1 (348B) or NIfTI-2 (540B) header, either endianness.

    Returns dict with shape, datatype, pixdim[8], vox_offset, scl, endian
    ('<' or '>'), version, and sform rows (or None).
    """
    if len(hdr) < 348:
        raise ValueError(f"{path}: truncated NIfTI header ({len(hdr)} bytes)")
    size_le = struct.unpack_from("<i", hdr, 0)[0]
    size_be = struct.unpack_from(">i", hdr, 0)[0]
    if size_le == 348 or size_be == 348:
        version, en = 1, ("<" if size_le == 348 else ">")
    elif size_le == 540 or size_be == 540:
        version, en = 2, ("<" if size_le == 540 else ">")
    else:
        raise ValueError(
            f"{path}: not a NIfTI file (sizeof_hdr={size_le}, expected 348 "
            "for NIfTI-1 or 540 for NIfTI-2)")
    if version == 1:
        magic = hdr[344:348]
        # empty magic = ANALYZE-7.5-style header; read as single-file NIfTI-1
        if magic[:3] not in (b"n+1", b"ni1", b"\x00\x00\x00"):
            raise ValueError(f"{path}: bad NIfTI-1 magic {magic!r}")
        dim = struct.unpack_from(f"{en}8h", hdr, 40)
        datatype = struct.unpack_from(f"{en}h", hdr, 70)[0]
        pixdim = struct.unpack_from(f"{en}8f", hdr, 76)
        vox_offset = int(struct.unpack_from(f"{en}f", hdr, 108)[0])
        scl_slope, scl_inter = struct.unpack_from(f"{en}2f", hdr, 112)
        sform_code = struct.unpack_from(f"{en}h", hdr, 254)[0]
        srow = (np.array(struct.unpack_from(f"{en}12f", hdr, 280),
                         np.float64).reshape(3, 4)
                if sform_code > 0 else None)
        detached = magic[:3] == b"ni1"
    else:
        if len(hdr) < 540:
            raise ValueError(f"{path}: truncated NIfTI-2 header")
        magic = hdr[4:8]
        if magic[:3] not in (b"n+2", b"ni2"):
            raise ValueError(f"{path}: bad NIfTI-2 magic {magic!r}")
        datatype = struct.unpack_from(f"{en}h", hdr, 12)[0]
        dim = struct.unpack_from(f"{en}8q", hdr, 16)
        pixdim = struct.unpack_from(f"{en}8d", hdr, 104)
        vox_offset = int(struct.unpack_from(f"{en}q", hdr, 168)[0])
        scl_slope, scl_inter = struct.unpack_from(f"{en}2d", hdr, 176)
        sform_code = struct.unpack_from(f"{en}i", hdr, 348)[0]
        srow = (np.array(struct.unpack_from(f"{en}12d", hdr, 400),
                         np.float64).reshape(3, 4)
                if sform_code > 0 else None)
        detached = magic[:3] == b"ni2"
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: invalid NIfTI dim[0]={ndim}")
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    if any(d <= 0 for d in shape):
        raise ValueError(f"{path}: invalid NIfTI shape {shape}")
    return dict(shape=shape, datatype=int(datatype),
                pixdim=np.asarray(pixdim, np.float64),
                vox_offset=vox_offset, scl_slope=float(scl_slope),
                scl_inter=float(scl_inter), endian=en, version=version,
                srow=srow, detached=detached)


def _zooms_from_header(h: dict) -> np.ndarray:
    """Voxel sizes, by the NIfTI method precedence: sform column norms when
    present (robust to rotated/flipped/sheared orientation matrices — the
    srow can encode zooms different from pixdim), else |pixdim[1:4]|.

    The qform needs no separate computation: its affine is
    ``rotation @ diag(pixdim * [1,1,qfac])`` with an ORTHONORMAL rotation
    (unit quaternion, renormalized per the spec), so its column norms are
    identically |pixdim| — for scanner-native files with qform_code>0,
    sform_code=0 the pixdim branch below IS the qform-correct spacing."""
    if h["srow"] is not None:
        z = np.linalg.norm(h["srow"][:, :3], axis=0)
        if np.all(np.isfinite(z)) and np.all(z > 0):
            return z.astype(np.float32)
    return np.abs(h["pixdim"][1:4]).astype(np.float32)


def load_nifti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """NIfTI loader: .nii/.nii.gz (NIfTI-1 AND NIfTI-2, either endianness)
    plus detached .hdr/.img pairs; honors scl_slope/scl_inter and
    qform/sform-aware voxel sizes.  Returns (data in file (x,y,z,...) order
    as float32, zooms[3])."""
    base = path
    if path.endswith((".img", ".img.gz")):
        base = path[: path.rindex(".img")] + ".hdr"
    try:
        raw = _read_file(base)
    except FileNotFoundError:
        if base.endswith(".hdr"):  # fully gzipped pair: x.hdr.gz + x.img.gz
            base += ".gz"
            raw = _read_file(base)
        else:
            raise
    h = _parse_nifti_header(raw, base)
    if h["detached"] or base.endswith((".hdr", ".hdr.gz")):
        img_path = base[: base.rindex(".hdr")] + ".img"
        try:
            raw = _read_file(img_path)
        except FileNotFoundError:
            raw = _read_file(img_path + ".gz")
        offset = max(0, h["vox_offset"])
    else:
        offset = h["vox_offset"] if h["vox_offset"] > 0 else (
            352 if h["version"] == 1 else 544)
    np_dtype = _NIFTI_DTYPES.get(h["datatype"])
    if np_dtype is None:
        raise ValueError(
            f"{path}: unsupported NIfTI datatype {h['datatype']}")
    dt = np.dtype(np_dtype).newbyteorder(h["endian"])
    count = int(np.prod(h["shape"]))
    if offset + count * dt.itemsize > len(raw):
        raise ValueError(f"{path}: file too short for shape {h['shape']}")
    data = np.frombuffer(raw, dtype=dt, count=count, offset=offset)
    data = data.reshape(h["shape"], order="F").astype(np.float32)
    # tool-exported files commonly carry trailing singleton dims
    # (dim[0]=4, nt=1): squeeze them so the [S,H,W] contract downstream
    # holds; a real 4D series (nt>1) still raises at the consumer
    while data.ndim > 3 and data.shape[-1] == 1:
        data = data[..., 0]
    slope, inter = h["scl_slope"], h["scl_inter"]
    if not np.isfinite(inter):
        # NIfTI convention (nibabel parity): a non-finite scl_inter means 0;
        # the slope must still be applied.
        inter = 0.0
    if np.isfinite(slope) and slope != 0.0 and (slope, inter) != (1.0, 0.0):
        data = data * np.float32(slope) + np.float32(inter)
    return data, _zooms_from_header(h)


def save_nifti(path: str, vol: np.ndarray, spacing=None) -> None:
    """Minimal NIfTI-1 writer (single-file .nii / .nii.gz) for prediction
    export — the inverse of :func:`load_nifti` for the subset this framework
    produces.

    ``vol`` is in the internal [S,H,W] = file (z,x,y) order (what
    ``load_volume_with_spacing`` returns); it is stored transposed back to
    file (x,y,z) order so third-party viewers (and our loader) agree.
    ``spacing`` is the internal (slice,row,col) spacing triple; written to
    pixdim AND an sform (code 1) so both spacing paths round-trip.
    Integer volumes (segmentation masks) store as uint8 when they fit,
    int32 otherwise; floats store as float32."""
    vol = np.asarray(vol)
    if vol.ndim != 3:
        raise ValueError(f"save_nifti expects [S,H,W], got {vol.shape}")
    if np.issubdtype(vol.dtype, np.integer) or np.issubdtype(
            vol.dtype, np.bool_):
        as_int = vol.astype(np.int64)
        dt, code = ((np.uint8, 2) if (as_int.min() >= 0
                                      and as_int.max() <= 255)
                    else (np.int32, 8))
    else:
        dt, code = np.float32, 16
    data = np.moveaxis(vol, 0, -1).astype(dt)  # (z,x,y) -> (x,y,z)
    sp = (np.ones(3, np.float64) if spacing is None
          else np.asarray(spacing, np.float64))
    zooms = np.array([sp[1], sp[2], sp[0]])  # (s,h,w) -> (x,y,z)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, np.dtype(dt).itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *zooms, 0.0, 0.0, 0.0, 0.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    srow = np.zeros((3, 4), np.float32)
    srow[:, :3] = np.diag(zooms)
    struct.pack_into("<12f", hdr, 280, *srow.reshape(-1))
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


def save_volume(path: str, vol: np.ndarray, spacing=None) -> None:
    """Save [S,H,W] by extension: .nii/.nii.gz (NIfTI-1), .npz (with a
    'spacing' key), or .npy (spacing dropped)."""
    if path.endswith((".nii", ".nii.gz")):
        save_nifti(path, vol, spacing)
    elif path.endswith(".npz"):
        np.savez_compressed(
            path, volume=vol,
            spacing=np.asarray(spacing if spacing is not None
                               else np.ones(3), np.float32))
    elif path.endswith(".npy"):
        np.save(path, vol)
    else:
        raise ValueError(f"unsupported volume extension: {path}")


def load_volume(path: str, key: str | None = None) -> np.ndarray:
    """Load a 3D volume from .npz/.npy/.nii/.nii.gz as float32 [S,H,W]."""
    return load_volume_with_spacing(path, key)[0]


def load_volume_with_spacing(path: str, key: str | None = None):
    """Load a 3D volume from .npz/.npy/.nii/.nii.gz as float32 [S,H,W],
    with its voxel spacing [3] (slice,row,col) when the format records it
    (NIfTI pixdim; npz key 'spacing'), else unit spacing."""
    if path.endswith((".nii", ".nii.gz", ".hdr", ".hdr.gz", ".img", ".img.gz")):
        data, zooms = load_nifti(path)
        # benchmark slicing is along the last file axis -> move to front
        vol = np.ascontiguousarray(np.moveaxis(data, -1, 0)).astype(np.float32)
        spacing = np.asarray([zooms[2], zooms[0], zooms[1]], np.float32)
        return vol, spacing
    if path.endswith(".npz"):
        with np.load(path) as z:
            arr = z[key] if key else z[[f for f in z.files
                                        if f != "spacing"][0]]
            spacing = (np.asarray(z["spacing"], np.float32)
                       if "spacing" in z.files else np.ones(3, np.float32))
        return np.asarray(arr, np.float32), spacing
    return np.load(path).astype(np.float32), np.ones(3, np.float32)


# ------------------------------------------------------------ normalization
def normalize_volume(vol: np.ndarray, clip_percentiles=(0.5, 99.5)) -> np.ndarray:
    """Per-volume zero-mean/unit-variance after percentile clipping (D2).

    The reference's released data was pre-normalized offline this way
    [P1 SIV]; here it is a library function so raw volumes work too.
    """
    v = vol.astype(np.float32)
    lo, hi = np.percentile(v, clip_percentiles)
    v = np.clip(v, lo, hi)
    std = v.std()
    return (v - v.mean()) / (std + 1e-8)


# --------------------------------------------------------- slice extraction
@dataclass
class SliceDataset:
    """All context-stacked slices of a split, materialized as flat arrays
    ready for device feeds: images [N,H,W,ctx] f32, labels [N,H,W] int32
    (labels may be None for the unlabeled target split)."""

    images: np.ndarray
    labels: np.ndarray | None
    volume_ids: np.ndarray  # [N] which volume each slice came from
    slice_ids: np.ndarray   # [N] index within its volume

    def __len__(self):
        return self.images.shape[0]


def stack_context(vol: np.ndarray, context: int = 3) -> np.ndarray:
    """[S,H,W] -> [S,H,W,context]: each output slice is its `context`
    adjacent slices stacked as channels, edge-clamped (D1)."""
    if context % 2 != 1:
        raise ValueError(f"context must be odd, got {context}")
    half = context // 2
    s = vol.shape[0]
    idx = np.arange(s)[:, None] + np.arange(-half, half + 1)[None, :]
    idx = np.clip(idx, 0, s - 1)
    return np.moveaxis(vol[idx], 1, -1)  # [S,H,W,context]


def volumes_to_slices(vols, labels=None, context: int = 3,
                      drop_empty: bool = False) -> SliceDataset:
    """Build a SliceDataset from lists of [S,H,W] volumes (+ label volumes).

    ``drop_empty`` discards slices whose label is all-background -- the usual
    trick to keep foreground frequency up in cardiac training sets.
    """
    imgs, labs, vids, sids = [], [], [], []
    for vi, vol in enumerate(vols):
        stacked = stack_context(vol, context)
        lab = labels[vi] if labels is not None else None
        keep = np.arange(vol.shape[0])
        if drop_empty and lab is not None:
            keep = keep[(lab > 0).any(axis=(1, 2))]
            if keep.size == 0:
                keep = np.arange(vol.shape[0])
        imgs.append(stacked[keep])
        if lab is not None:
            labs.append(lab[keep].astype(np.int32))
        vids.append(np.full(len(keep), vi, np.int32))
        sids.append(keep.astype(np.int32))
    return SliceDataset(
        images=np.concatenate(imgs, 0),
        labels=np.concatenate(labs, 0) if labels is not None else None,
        volume_ids=np.concatenate(vids, 0),
        slice_ids=np.concatenate(sids, 0),
    )

