"""Inputs of a run, made on the device from the seed: synthetic cardiac
phantoms, the slice datasets and serving volumes built from them, and the
weights both sides start from.

Phantoms: the recipe's synthetic MM-WHS stand-in (``data/synthetic.py`` of
the package), redrawn with torch on the device: four structures (AA, LAC,
LVC, MYO as a shell around LVC) as jittered ellipsoids over [-1, 1]^3,
per-domain class intensities, a smooth bias field, Gaussian noise, each
volume normalised to zero mean and unit variance.  Labels 0 = background,
1 = AA, 2 = LAC, 3 = LVC, 4 = MYO.

Weights: He-normal convs and identity BN for training (the recipe's
initialiser), drawn in one call per tree; serving gets an adapted state
whose BN statistics and affine terms are drawn too, so the eval-mode net
is not the identity-BN one, and whose DAM stages are drawn apart from the
frozen ones.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import pnp_adanet as ref

_INTENSITY = {"mri": (0.05, 0.85, 0.55, 0.70, 0.35),
              "ct": (0.10, 0.40, 0.80, 0.30, 0.65)}
_BIAS = {"mri": 0.08, "ct": 0.03}
_NOISE = {"mri": 0.06, "ct": 0.04}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a run."""
    g = torch.Generator(device=device)
    g.manual_seed(ref.fold_in(seed, stream))
    return g


def phantoms(gen, n: int, depth: int, size: int, domain: str, device):
    """(images [n,depth,size,size] f32, labels [n,depth,size,size] uint8)."""
    lin = lambda k: torch.linspace(-1, 1, k, device=device)  # noqa: E731
    zz = lin(depth)[:, None, None]
    yy = lin(size)[None, :, None]
    xx = lin(size)[None, None, :]
    # per volume: 10 centre / radius jitters per structure, 2 bias phases
    j = torch.rand((n, 32), generator=gen, device=device) * 2 - 1
    noise = torch.randn((n, depth, size, size), generator=gen, device=device)
    means = torch.tensor(_INTENSITY[domain], device=device)
    images = torch.empty((n, depth, size, size), device=device)
    labels = torch.empty((n, depth, size, size), dtype=torch.uint8,
                         device=device)
    for v in range(n):
        u = j[v]

        def ell(c, r):
            return (((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
                    + ((xx - c[2]) / r[2]) ** 2) <= 1.0

        lvc_c = (0.15 * u[0], -0.25 + 0.1 * u[1], 0.1 * u[2])
        lvc_r = (0.55 + 0.1 * u[3], 0.28 + 0.05 * u[4], 0.28 + 0.05 * u[5])
        lab = torch.zeros((depth, size, size), dtype=torch.uint8,
                          device=device)
        lab[ell(lvc_c, tuple(r * 1.45 for r in lvc_r))] = 4
        lab[ell(lvc_c, lvc_r)] = 3
        lac = ell((0.15 * u[6], 0.35 + 0.1 * u[7], -0.25 + 0.1 * u[8]),
                  (0.45 + 0.1 * u[9], 0.22 + 0.05 * u[10],
                   0.25 + 0.05 * u[11]))
        lab[lac & (lab == 0)] = 2
        aa = ell((0.2 * u[12], 0.3 + 0.1 * u[13], 0.45 + 0.1 * u[14]),
                 (0.5 + 0.1 * u[15], 0.16 + 0.04 * u[16],
                  0.16 + 0.04 * u[17]))
        lab[aa & (lab == 0)] = 1
        bias = (torch.sin(3.0 * xx + 2 * u[18]) * torch.cos(2.0 * yy
                                                            + 2 * u[19])
                * _BIAS[domain])
        img = means[lab.long()] + bias + _NOISE[domain] * noise[v]
        images[v] = (img - img.mean()) / (img.std() + 1e-8)
        labels[v] = lab
    return images, labels


def stack_context(volumes, context: int = 3):
    """[n,S,H,W] -> [n*S,H,W,context]: each slice with its edge-clamped
    neighbours as channels."""
    n, s = volumes.shape[:2]
    half = context // 2
    idx = torch.clamp(torch.arange(s, device=volumes.device)[:, None]
                      + torch.arange(-half, half + 1,
                                     device=volumes.device)[None, :],
                      0, s - 1)
    out = volumes[:, idx]                       # [n,S,ctx,H,W]
    return out.permute(0, 1, 3, 4, 2).reshape(n * s, *volumes.shape[2:],
                                              context)


# ----------------------------------------------------------------- weights
def _he(gen, shapes: dict, device):
    """He-normal draws for every conv weight of ``shapes`` (keys ending in
    "w"), from one call."""
    keys = [k for k in shapes if k[-1] == "w"]
    sizes = [math.prod(shapes[k]) for k in keys]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, part in zip(keys, torch.split(flat, sizes)):
        kh, kw, cin, _ = shapes[k]
        out[k] = part.view(shapes[k]) * math.sqrt(2.0 / (kh * kw * cin))
    return out


def segmenter_init(seed: int, stream: int, device):
    """(params, BN state) as flat {path: tensor}: He-normal convs, zero
    head bias, identity BN."""
    pshapes, sshapes = ref.segmenter_shapes()
    params = _he(generator(seed, stream, device), pshapes, device)
    for k, shape in pshapes.items():
        if k not in params:
            params[k] = (torch.ones if k[-1] == "scale" else torch.zeros)(
                shape, device=device)
    state = {k: (torch.ones if k[-1] == "var" else torch.zeros)(
        shape, device=device) for k, shape in sshapes.items()}
    return params, state


def critic_init(seed: int, stream: int, device):
    shapes = ref.critic_shapes()
    params = _he(generator(seed, stream, device), shapes, device)
    for k, shape in shapes.items():
        params.setdefault(k, torch.zeros(shape, device=device))
    return params


def _drawn_bn(gen, leaves: dict, device) -> dict:
    """BN scale U(0.25, 1), bias and running mean N(0, 0.1), running
    variance U(0.5, 2), the head bias N(0, 0.1), from two calls."""
    keys = [k for k in leaves if k[-1] in ("scale", "bias", "mean", "var",
                                           "b")]
    sizes = [leaves[k].numel() for k in keys]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    g = torch.randn(sum(sizes), generator=gen, device=device) * 0.1
    out = dict(leaves)
    for k, uu, gg in zip(keys, torch.split(u, sizes), torch.split(g, sizes)):
        shape = leaves[k].shape
        out[k] = {"scale": 0.25 + 0.75 * uu, "var": 0.5 + 1.5 * uu}.get(
            k[-1], gg).view(shape)
    return out


def serving_state(seed: int, plug_depth: str, device):
    """An adapted state: (frozen params, DAM params of the stages up to
    ``plug_depth``, target BN state), flat leaves, all drawn."""
    params, state = segmenter_init(seed, 11, device)
    params = _drawn_bn(generator(seed, 12, device), params, device)
    state = _drawn_bn(generator(seed, 13, device), state, device)
    dam_all, _ = segmenter_init(seed, 14, device)
    dam_all = _drawn_bn(generator(seed, 15, device), dam_all, device)
    names = []
    for name, *_ in ref.STAGES:
        names.append(name)
        if name == plug_depth:
            break
    dam = {k: v for k, v in dam_all.items() if k[0] in names}
    return params, dam, state
