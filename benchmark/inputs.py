"""Seeded inputs of a cell: smooth textures moved by known motions, as u16
planes in host memory.

Plain PyTorch on the device the run uses, none of the port's functions:
each channel is its own smooth random texture, as the traffic mix's
``texture`` block states it (a weighted sum of Gaussian blurs of uniform
noise, min-max normalised, optionally times a mask of blobs that cover a
set share of the plane), and each cycle moves every channel by the cycle's
motion, an affine (rotation about the centre, then a shift) and a smooth
non-linear warp of whole sine periods, then scales it into the u16 range.
Cycle 0 is the reference cycle and does not move.

The seed draws the noise, the order in which the motion sizes of the
configuration's ``assumed`` block go to the cycles, the warps' phases, the
shifts' directions and the rotations' signs.  Every seed gets the same set
of sizes, so every seed gives the run the same work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROW_CHUNK = 2048  # output rows a gather: bounds the coordinate tensors
QUANTILE_SAMPLES = 1 << 22  # values a mask's threshold is drawn from


def blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of an (H, W) float32 tensor, ksize 6 sigma | 1,
    reflected borders, as shifted-slice sums along each axis."""
    r = int(6 * sigma) // 2
    k = torch.exp(-(torch.arange(-r, r + 1, dtype=torch.float64) ** 2) / (2 * sigma * sigma))
    k = (k / k.sum()).tolist()
    for axis in (0, 1):
        n = x.shape[axis]
        idx = torch.arange(-r, n + r, device=x.device).abs()
        idx = torch.where(idx >= n, 2 * n - 2 - idx, idx)
        xp = x.index_select(axis, idx)
        acc = xp.narrow(axis, 0, n) * k[0]
        for i in range(1, 2 * r + 1):
            acc += xp.narrow(axis, i, n) * k[i]
        x = acc
    return x


def smooth_noise(h: int, w: int, sigmas, weights, gen: torch.Generator, device) -> torch.Tensor:
    """sum_i weights[i] * blur(noise, sigmas[i]) of one uniform noise,
    min-max normalised to [0, 1], float32 (H, W) on ``device``."""
    noise = torch.rand((h, w), generator=gen, device=device, dtype=torch.float32)
    out = None
    for sigma, weight in zip(sigmas, weights):
        term = blur(noise, float(sigma)) * float(weight)
        out = term if out is None else out.add_(term)
    del noise
    lo, hi = out.min(), out.max()
    return (out - lo) / (hi - lo)


def texture(h: int, w: int, spec: dict, gen: torch.Generator, device) -> torch.Tensor:
    """Smooth random texture in [0, 1], float32 (H, W) on ``device``, as
    ``spec`` states it: ``blur_sigmas_px`` and ``blur_weights``; with a
    ``mask`` (``sigma_px``, ``coverage``, ``edge``), the texture only
    inside blobs of a second smooth noise that cover ``coverage`` of the
    plane, their edges ramping over ``edge`` of that noise's range."""
    out = smooth_noise(h, w, spec["blur_sigmas_px"], spec["blur_weights"], gen, device)
    mask = spec.get("mask")
    if mask:
        field = smooth_noise(h, w, [mask["sigma_px"]], [1.0], gen, device)
        step = max(1, field.numel() // QUANTILE_SAMPLES)
        cut = torch.quantile(field.reshape(-1)[::step], 1.0 - float(mask["coverage"]))
        out.mul_(torch.clamp((field - cut) / float(mask["edge"]) + 0.5, 0.0, 1.0))
        del field
    return out


def sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Bilinear ``img`` at absolute coordinates (xs, ys), zero outside."""
    h, w = img.shape
    x0, y0 = torch.floor(xs), torch.floor(ys)
    tx, ty = xs - x0, ys - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape(-1)
    out = torch.zeros_like(xs)
    for dy, dx, wgt in ((0, 0, (1 - tx) * (1 - ty)), (0, 1, tx * (1 - ty)), (1, 0, (1 - tx) * ty), (1, 1, tx * ty)):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = flat[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(-1)].reshape(xs.shape)
        out += torch.where(inside, v, 0.0) * wgt
    return out


class Motion:
    """``mov(p) = tex(A p + d(p))``: ``A`` a rotation by ``degrees`` about
    the centre followed by ``shift`` (x, y); ``d`` a smooth warp of
    amplitude ``amp`` px, ``d = amp (sin(y / L + phase), 0.7 cos(x / L - phase))``."""

    def __init__(self, degrees: float, shift, amp: float, phase: float, wavelength: float):
        self.degrees, self.shift = degrees, tuple(shift)
        self.amp, self.phase, self.wavelength = amp, phase, wavelength

    def coords(self, h: int, w: int, r0: int, r1: int, device):
        """Source coordinates (xs, ys) of output rows [r0, r1)."""
        ys = torch.arange(r0, r1, device=device, dtype=torch.float32).view(-1, 1)
        xs = torch.arange(w, device=device, dtype=torch.float32).view(1, -1)
        a, b = math.cos(math.radians(self.degrees)), math.sin(math.radians(self.degrees))
        cx, cy = w / 2.0, h / 2.0
        sx = a * (xs - cx) - b * (ys - cy) + cx + self.shift[0]
        sy = b * (xs - cx) + a * (ys - cy) + cy + self.shift[1]
        k = 2 * math.pi / self.wavelength
        sx = sx + self.amp * torch.sin(ys * k + self.phase)
        sy = sy + 0.7 * self.amp * torch.cos(xs * k - self.phase)
        return sx, sy


def motions(assumed: dict, cycles: int, rng: np.random.Generator) -> list:
    """The motion of each cycle, the reference cycle's first (identity):
    the sizes of ``assumed`` dealt to the moving cycles in an order drawn
    from ``rng``."""
    moving = cycles - 1
    amps = rng.permutation(np.asarray(assumed["warp_amplitude_px"], float))
    shifts = rng.permutation(np.asarray(assumed["affine_shift_px"], float))
    degrees = rng.permutation(np.asarray(assumed["rotation_deg"], float))
    if not len(amps) == len(shifts) == len(degrees) == moving:
        raise ValueError(f"assumed: each motion list needs {moving} sizes, one a moving cycle")
    out = [Motion(0.0, (0.0, 0.0), 0.0, 0.0, assumed["warp_wavelength_px"])]
    for c in range(moving):
        angle = rng.uniform(0, 2 * math.pi)
        sign = rng.choice((-1.0, 1.0))
        out.append(Motion(sign * degrees[c], (shifts[c] * math.cos(angle), shifts[c] * math.sin(angle)),
                          amps[c], rng.uniform(0, 2 * math.pi), assumed["warp_wavelength_px"]))
    return out


def make_planes(config: dict, traffic: dict, seed: int, device) -> np.ndarray:
    """(cycles, channels, z, H, W) u16 host planes of one run, made on
    ``device`` from ``seed``: plane (c, ch, z) is the moved texture of
    channel ch times ``(z_gain[0] + z_gain[1] z) (channel_gain[0] +
    channel_gain[1] ch) scale``, plus ``offset``."""
    h, w = config["plane"]
    cycles, channels, zs = traffic["cycles"], traffic["channels"], traffic["z_planes"]
    spec = traffic["texture"]
    rng = np.random.default_rng(seed)
    moves = motions(config["assumed"], cycles, rng)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2**62)))
    out = np.empty((cycles, channels, zs, h, w), dtype=np.uint16)
    host = torch.from_numpy(out)
    for ch in range(channels):
        tex = texture(h, w, spec, gen, device)
        for c, move in enumerate(moves):
            for r0 in range(0, h, ROW_CHUNK):
                r1 = min(h, r0 + ROW_CHUNK)
                moved = sample(tex, *move.coords(h, w, r0, r1, device))
                for z in range(zs):
                    gain = (spec["z_gain"][0] + spec["z_gain"][1] * z) * (
                        spec["channel_gain"][0] + spec["channel_gain"][1] * ch)
                    level = moved * (gain * spec["scale"]) + spec["offset"]
                    host[c, ch, z, r0:r1].copy_(torch.clamp(torch.round(level), 0, 65535).to(torch.int32)
                                                .to(torch.uint16))
        del tex
    return out
