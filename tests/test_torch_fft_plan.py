"""The STFT (#1) and iSTFT (#10) kernels' FFT plan on the CPU.

``csrc/stft.cu`` runs on the card only, so its arithmetic is emulated here in
plain torch, step for step: the tables the wrapper uploads
(``fft_tables_np``), the Stockham stages of ``csrc/fft.cuh`` in the order
``fft_stages`` gives, the packing of a real frame into ``n_fft // 2`` complex
values and the split into bins (and its inverse), and the overlap-add's
gather.  The emulation is held against the JAX package: its
``ops/stft.py::stft``, the Pallas ``_windowed_frames`` behind
``istft_pallas`` in interpret mode (as tests/test_stft_pallas.py runs it on
the CPU) and ``ops/stft.py::istft``; from numpy inputs made from a seed, at
every n_fft the kernels take, 2-3 frames each, fp32."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.ops import stft as JS
from mss_tf_locoformer_tpu.ops.pallas import stft_kernel as JK
from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK

# (n_fft, hop): the speech configs' 128/64 and 256/128, then hop n_fft / 4
SIZES = [(128, 64), (256, 128), (512, 128), (1024, 256), (2048, 512), (4096, 1024)]
# Both sides fp32 (FFTs by different butterflies, or the Pallas DFT product at
# HIGHEST precision): rounding grows with log2 n_fft, ~1e-6 of max at 4096;
# a wrong twiddle, bin, sign or window sample is O(1).
TOL = 1e-5


def _dft4(a):
    b0, b1, b2, b3 = a[0] + a[2], a[0] - a[2], a[1] + a[3], -1j * (a[1] - a[3])
    return [b0 + b2, b1 + b3, b0 - b2, b1 - b3]


def _dft8(a):
    """``fft.cuh::dft8``: even outputs DFT_4(a_r + a_{r+4}), odd ones
    DFT_4((a_r - a_{r+4}) W_8^r)."""
    h = float(np.float32(0.70710678118654752))   # the kernel's fp32 constant
    c = [a[r] - a[r + 4] for r in range(4)]
    c[1], c[2], c[3] = (1 - 1j) * h * c[1], -1j * c[2], (-1 - 1j) * h * c[3]
    even, odd = _dft4([a[r] + a[r + 4] for r in range(4)]), _dft4(c)
    return [v for pair in zip(even, odd) for v in pair]


def _fft(z: torch.Tensor, n_fft: int) -> torch.Tensor:
    """``fft.cuh::forward`` on ``z [..., M]`` (complex64): each stage reads
    x[i + r M/R], multiplies by its twiddle W_{Rp}^{rk} (k = i mod p) from
    the stage's part of the table, runs the kernel's radix-R butterfly and
    writes y[(i - k) R + k + r p]."""
    tw = torch.from_numpy(SK.fft_tables_np(n_fft)[0])
    m, at = z.shape[-1], 0
    first = {1: 2, 2: 4, 0: 8}[(m.bit_length() - 1) % 3]   # the kernel's P1
    for radix, p in SK.fft_stages(n_fft):
        assert p == 1 or at == p - first   # fft.cuh reads tw[p - P1 + ...]
        i = torch.arange(m // radix)
        k = i % p
        a = [z[..., i]]
        for r in range(1, radix):
            w = tw[at + (r - 1) * p + k] if p > 1 else 1
            a.append(z[..., i + r * (m // radix)] * w)
        at += (radix - 1) * p if p > 1 else 0
        v = {2: lambda a: [a[0] + a[1], a[0] - a[1]], 4: _dft4, 8: _dft8}[radix](a)
        y = torch.empty_like(z)
        j = (i - k) * radix + k
        for r in range(radix):
            y[..., j + r * p] = v[r]
        z = y
    return z


def _emulate_stft(audio: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """#1: ``[B, T]`` -> complex ``[B, F, N]``; each bin split from Z[f] and
    Z[M - f] on the way out."""
    _, split, window = (torch.from_numpy(a) for a in SK.fft_tables_np(n_fft))
    m, t = n_fft // 2, audio.shape[-1]
    n_frames = 1 + t // hop
    q = np.arange(n_frames)[:, None] * hop + np.arange(n_fft) - m   # reflect padding
    q = np.abs(q)
    q = np.where(q >= t, 2 * (t - 1) - q, q)
    frames = torch.from_numpy(audio)[:, q] * window
    z = _fft(torch.complex(frames[..., 0::2], frames[..., 1::2]), n_fft)
    f = torch.arange(1, m)
    zf, zc = z[..., f], z[..., m - f].conj()
    xe, xo = (zf + zc) * 0.5, -1j * ((zf - zc) * 0.5)
    x = torch.empty(z.shape[:-1] + (m + 1,), dtype=torch.complex64)
    x[..., f] = xe + split[f] * xo
    x[..., 0] = (z[..., 0].real + z[..., 0].imag).to(torch.complex64)
    x[..., m] = (z[..., 0].real - z[..., 0].imag).to(torch.complex64)
    return x.transpose(-1, -2).numpy()


def _emulate_frames(spec: np.ndarray, n_fft: int) -> torch.Tensor:
    """#10's frames: complex ``[R, F, N]`` -> windowed ``[R, N, n_fft]``;
    bins k and M - k read together and the split undone on the way in."""
    _, split, window = (torch.from_numpy(a) for a in SK.fft_tables_np(n_fft))
    m = n_fft // 2
    x = torch.from_numpy(spec).transpose(-1, -2)
    k = torch.arange(1, m // 2 + 1)
    xk, xc = x[..., k], x[..., m - k].conj()
    a = xk + xc
    c = 1j * (split[k].conj() * (xk - xc))
    z = torch.empty(x.shape[:-1] + (m,), dtype=torch.complex64)
    z[..., k] = (a + c).conj()
    z[..., m - k] = a - c
    dc, nyq = x[..., 0].real, x[..., m].real   # imaginary parts dropped
    z[..., 0] = torch.complex(dc + nyq, nyq - dc)
    y = _fft(z, n_fft)
    frames = torch.stack([y.real, -y.imag], -1).flatten(-2)
    return frames * window * (1.0 / n_fft)


def _emulate_overlap_add(frames: torch.Tensor, n_fft: int, hop: int, length: int):
    """The overlap-add kernel: each output sample gathers the frames that
    cover it and divides by their summed squared window."""
    window = torch.from_numpy(SK.fft_tables_np(n_fft)[2])
    n_frames = frames.shape[-2]
    q = torch.arange(length) + n_fft // 2
    n_lo = torch.where(q < n_fft, 0, torch.div(q - n_fft, hop, rounding_mode="floor") + 1)
    n_hi = torch.clamp(torch.div(q, hop, rounding_mode="floor"), max=n_frames - 1)
    y = torch.zeros(frames.shape[0], length)
    env = torch.zeros(length)
    for c in range(-(-n_fft // hop) + 1):
        n = n_lo + c
        ok = n <= n_hi
        j = torch.where(ok, q - n * hop, 0)
        y += torch.where(ok, frames[:, n.clamp(max=n_frames - 1), j], 0.0)
        env += torch.where(ok, window[j] ** 2, 0.0)
    return y / torch.where(env > 1e-11, env, 1.0)


def _audio(rng, n_fft, hop):
    # 2 frames at hop n_fft / 2, 3 at hop n_fft / 4; longer than the
    # reflect padding of n_fft / 2
    return rng.standard_normal((2, n_fft // 2 + 37), dtype=np.float32)


@pytest.mark.parametrize("n_fft,hop", SIZES)
def test_stft_plan_matches_jax(rng, n_fft, hop):
    audio = _audio(rng, n_fft, hop)
    want = np.asarray(JS.stft(jnp.asarray(audio), n_fft, hop))
    got = _emulate_stft(audio, n_fft, hop)
    assert got.shape == want.shape and want.shape[-1] in (2, 3)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("n_fft,hop", SIZES)
def test_istft_plan_matches_pallas(rng, n_fft, hop):
    audio = _audio(rng, n_fft, hop)
    spec = np.array(JS.stft(jnp.asarray(audio), n_fft, hop))
    spec[:, 0] += 1j   # imaginary DC and Nyquist parts: dropped on both sides
    spec[:, -1] -= 2j
    r, f, n = spec.shape
    f_pad, n_pad = -(-f // JK.LANE) * JK.LANE, -(-n // JK.BLK_N) * JK.BLK_N
    re = np.zeros((r, n_pad, f_pad), np.float32)
    im = np.zeros_like(re)
    re[:, :n, :f] = spec.real.transpose(0, 2, 1)
    im[:, :n, :f] = spec.imag.transpose(0, 2, 1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JK._windowed_frames(jnp.asarray(re), jnp.asarray(im), n_fft))[:, :n]
    frames = _emulate_frames(spec, n_fft)
    np.testing.assert_allclose(frames.numpy(), want, atol=TOL * np.abs(want).max(), rtol=0)
    # the overlap-add: the whole iSTFT cropped to the input's length against
    # JAX's; zero-padded past the end against ``istft_pallas``'s overlap-add
    # on the same frames (the last samples divide by a vanishing envelope,
    # so only the same frames and window agree there to rounding)
    length = audio.shape[-1]
    want = np.asarray(JS.istft(jnp.asarray(spec), n_fft, hop, length=length))
    got = _emulate_overlap_add(frames, n_fft, hop, length).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)
    full, w = (n - 1) * hop + n_fft, JS.hann_window(n_fft)
    env = JS._overlap_add(jnp.broadcast_to(w * w, (n, n_fft)), hop, full)
    want = np.asarray(JS._overlap_add(jnp.asarray(frames.numpy()), hop, full)
                      / jnp.where(env > 1e-11, env, 1.0))[:, n_fft // 2:]
    got = _emulate_overlap_add(frames, n_fft, hop, want.shape[-1] + 5).numpy()
    assert not got[:, -5:].any()
    np.testing.assert_allclose(got[:, :-5], want, atol=TOL * np.abs(want).max(), rtol=0)


def test_every_config_fits_the_kernels():
    """Every config's STFT size is one the kernels take, in stages whose
    radices multiply to ``n_fft // 2``."""
    import pathlib
    sizes = set()
    for path in pathlib.Path(__file__).parents[1].joinpath("configs").glob("*.yaml"):
        text = path.read_text()
        n_fft = re.search(r"n_fft:\s*(\d+)", text)
        if n_fft:
            sizes.add((int(n_fft.group(1)), int(re.search(r"hop_length:\s*(\d+)", text)[1])))
    assert {s[0] for s in sizes} == {128, 256, 1024, 2048, 4096}
    for n_fft, _ in sizes:
        assert SK.N_FFT_MIN <= n_fft <= SK.N_FFT_MAX and n_fft & (n_fft - 1) == 0
        stages = SK.fft_stages(n_fft)
        assert np.prod([radix for radix, _ in stages]) == n_fft // 2
