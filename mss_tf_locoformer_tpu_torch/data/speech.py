"""Speech-separation mixture datasets (the JAX package's ``data/speech.py``):
the ``mix/ s1/ s2/ [...]`` parallel-directory layout of wsj0-2mix, WHAMR and
LibriMix.  WAV and FLAC files are listed, as in the JAX dataset, and read
through ``data/audio_io.py`` (WAV with numpy, FLAC with the native
decoder)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import audio_io
from .musdb import _pad_or_trim

__all__ = ["SpeechMixtureDataset"]

FILE_TYPES = (".wav", ".flac")


class SpeechMixtureDataset:
    """Parallel-directory speech mixtures.

    Expects ``root_dir/<mix_dir>/<utt>.wav`` and, for each speaker ``i``,
    ``root_dir/<spk_dirs[i]>/<utt>.wav`` with identical file names.  Yields
    ``{"mixture": [C, T], "sources": [S, C, T], "name": utt}``, cropped to
    ``segment_length`` samples when it is set: at a random offset drawn
    from a ``numpy`` generator seeded with ``seed`` (``random_crop``), else
    at 0, and zero-padded when shorter.  Files at another rate are
    resampled to ``sample_rate``.
    """

    def __init__(self, root_dir: str, num_spk: int = 2,
                 mix_dir: str = "mix", spk_dirs: Optional[Sequence[str]] = None,
                 segment_length: Optional[int] = None, sample_rate: int = 8000,
                 random_crop: bool = True, seed: int = 0):
        self.root = Path(root_dir)
        self.num_spk = num_spk
        self.mix_dir = mix_dir
        self.spk_dirs = list(spk_dirs) if spk_dirs else [
            f"s{i + 1}" for i in range(num_spk)]
        if len(self.spk_dirs) != num_spk:
            raise ValueError(f"{len(self.spk_dirs)} spk_dirs for num_spk={num_spk}")
        self.segment_length = segment_length
        self.sample_rate = sample_rate
        self.random_crop = random_crop
        self._rng = np.random.default_rng(seed)

        mix_root = self.root / mix_dir
        if not mix_root.is_dir():
            raise FileNotFoundError(f"Mixture directory not found: {mix_root}")
        self.utts: List[str] = sorted(
            p.name for p in mix_root.iterdir() if p.suffix.lower() in FILE_TYPES)
        missing = [u for u in self.utts
                   if not all((self.root / d / u).exists() for d in self.spk_dirs)]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} utterances missing speaker files, e.g. {missing[0]}")
        if not self.utts:
            raise FileNotFoundError(f"No audio files in {mix_root}")

    def __len__(self) -> int:
        return len(self.utts)

    def _read(self, path: Path, start: int, frames: Optional[int]) -> np.ndarray:
        data, sr = audio_io.read(str(path), start=start, frames=frames)
        if sr != self.sample_rate:
            data = audio_io.resample(data, sr, self.sample_rate)
        return np.ascontiguousarray(data.T, dtype=np.float32)       # [C, T]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        utt = self.utts[idx]
        mix_path = self.root / self.mix_dir / utt
        n_frames = audio_io.info(str(mix_path)).frames
        start, frames = 0, None
        if self.segment_length is not None:
            frames = self.segment_length
            if self.random_crop and n_frames > frames:
                start = int(self._rng.integers(0, n_frames - frames + 1))
        mixture = self._read(mix_path, start, frames)
        sources = np.stack([self._read(self.root / d / utt, start, frames)
                            for d in self.spk_dirs])
        if self.segment_length is not None:
            mixture = _pad_or_trim(mixture, self.segment_length)
            sources = np.stack([_pad_or_trim(s, self.segment_length) for s in sources])
        return {"mixture": mixture, "sources": sources, "name": utt}
