"""Audio made from the seed on the device, for every traffic mix.

A voice is a sine whose pitch and level change every half second, drawn
log-uniformly from a pitch range; a song is four voices (bass, two middle
voices, a high one) plus a little noise, in stereo with a narrower right
channel.  Training stems are four such signals of distinct ranges: bass,
drums (noise with decaying bursts), vocals, other.  Levels stay within
[-1, 1] as a normalised recording does.
"""

from __future__ import annotations

import math

import torch


def _voice(n: int, sr: int, lo_hz: float, hi_hz: float, level: float, gen, device, rows=1):
    seg = sr // 2
    nseg = -(-n // seg)
    pitch = lo_hz * (hi_hz / lo_hz) ** torch.rand(rows, nseg, generator=gen, device=device)
    amp = level * torch.rand(rows, nseg, generator=gen, device=device)
    idx = torch.arange(n, device=device) // seg
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    phase = (2 * math.pi * pitch[:, idx].double() * t).remainder(2 * math.pi).float()
    return amp[:, idx] * torch.sin(phase)


def song(n: int, sr: int, seed: int, device) -> torch.Tensor:
    """A stereo song ``[2, n]`` (fp32, on ``device``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (_voice(n, sr, 40, 160, 0.25, gen, device) + _voice(n, sr, 150, 600, 0.15, gen, device)
         + _voice(n, sr, 200, 900, 0.15, gen, device) + _voice(n, sr, 600, 3000, 0.08, gen, device))[0]
    noise = 0.01 * torch.randn(2, n, generator=gen, device=device)
    return torch.stack([x, 0.8 * x]) + noise


def stems(batch: int, n: int, sr: int, seed: int, device) -> dict:
    """Four stems ``[batch, n]`` each (fp32, on ``device``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bursts = torch.exp(-((torch.arange(n, device=device) % (sr // 4)) / (0.03 * sr)))
    return {
        "vocals": _voice(n, sr, 200, 900, 0.2, gen, device, batch),
        "drums": 0.2 * bursts * torch.randn(batch, n, generator=gen, device=device),
        "bass": _voice(n, sr, 40, 160, 0.25, gen, device, batch),
        "other": (_voice(n, sr, 150, 600, 0.1, gen, device, batch)
                  + _voice(n, sr, 600, 3000, 0.05, gen, device, batch)),
    }
