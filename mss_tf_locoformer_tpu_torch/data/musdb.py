"""MUSDB18-HQ dataset on the host with numpy (the JAX package's
``data/musdb.py``, the part the base config uses):

  * layout ``<root>/<subset>/<track>/{mixture,vocals,drums,bass,other}``
    with ``.wav`` or ``.flac`` files, track metadata scanned from their
    headers, and kept in a metadata pickle (``metadata_cache``: the
    directory, or ``<root>/.cache`` for True) validated by ``CACHE_VERSION``
    and the dataset's config;
  * ``precompute_chunks``: the chunk index (offsets every ``chunk_hop``,
    half a segment by default, kept where the loudest stem's mean |x| over
    the zero-padded window passes ``min_loudness``), cached in a pickle
    (``chunk_cache``: a directory, the metadata cache's by default, False
    for none) under the same validation; samples are then the index's
    chunks in order;
  * training samples are random chunks of ``segment_length`` with the
    loudness filter (mean |x| of the stems >= ``min_loudness``, at most
    ``max_chunk_attempts`` draws, then the first chunk of a random track),
    drawn from ``random.Random(seed)`` exactly as the JAX dataset draws them;
  * missing stems are zeros; with ``rebuild_mixture`` the mixture is the sum
    of the stems;
  * ``segment_length=None`` gives full tracks (validation, evaluation);
    with ``return_metadata`` each sample carries its ``track_name``.

  * augmentation (training subset; ``augmentation=True`` or a dict of
    settings over the defaults): per-stem loudness gain, channel swap,
    polarity flip, then on the mixture alone either the MP3 round trip
    (``audiomentations`` where installed, else the ``data/codec.py``
    simulation) or Gaussian noise at a drawn SNR; all of it drawn from the
    dataset's seeded ``random.Random`` in the JAX dataset's order, so one
    seed gives the JAX dataset's arrays.

The pickles hold plain dicts, lists and strings only (the JAX dataset's
payloads), so either package reads the other's.  Samples are
``{'mixture': [C, T] float32, '<stem>': [C, T], ...}``.
"""

from __future__ import annotations

import os
import pickle
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import audio_io

__all__ = ["TrackInfo", "MUSDBDataset", "collate_fn", "CACHE_VERSION"]

CACHE_VERSION = 2
FILE_TYPES = (".wav", ".flac")


@dataclass(frozen=True)
class TrackInfo:
    name: str
    directory: Path
    length: int
    sample_rate: int
    channels: int
    mixture_path: Path
    source_paths: Dict[str, Optional[Path]]


def _default_aug_config() -> Dict[str, Any]:
    return {
        "loudness": (0.7, 1.3),
        "channel_swap_prob": 0.5,
        "polarity_prob": 0.1,
        "mp3_prob": 0.2,
        "mp3_bitrate": (96, 192),
        "noise_prob": 0.1,
        "noise_snr": (25.0, 40.0),
    }


def _pad_or_trim(audio: np.ndarray, target: int) -> np.ndarray:
    if audio.shape[-1] == target:
        return audio
    if audio.shape[-1] > target:
        return audio[..., :target]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, target - audio.shape[-1])]
    return np.pad(audio, pad)


class MUSDBDataset:
    def __init__(self, root_dir: str, subset: str = "train",
                 sample_rate: int = 44100, segment_length: Optional[int] = None,
                 sources: Optional[Sequence[str]] = None,
                 augmentation: Union[bool, Dict[str, Any]] = False,
                 random_chunks: bool = True,
                 min_loudness: float = 1e-4, max_chunk_attempts: int = 8,
                 rebuild_mixture: bool = True, precompute_chunks: bool = False,
                 chunk_hop: Optional[int] = None,
                 metadata_cache: Union[bool, str] = True,
                 chunk_cache: Union[None, bool, str] = None, verbose: bool = True,
                 seed: Optional[int] = None, return_metadata: bool = False):
        if segment_length is not None and segment_length <= 0:
            raise ValueError("segment_length must be positive")
        self.root_dir = Path(root_dir)
        self.subset = subset
        self.sample_rate = sample_rate
        self.segment_length = segment_length
        self.sources = list(sources or ["vocals", "other"])
        self.random_chunks = random_chunks
        self.min_loudness = max(0.0, float(min_loudness))
        self.max_chunk_attempts = max(1, int(max_chunk_attempts))
        self.rebuild_mixture = rebuild_mixture
        self.return_metadata = return_metadata
        self.verbose = verbose
        self.chunk_hop = chunk_hop
        self._rng = random.Random(seed)
        self.augmentation = bool(augmentation) or isinstance(augmentation, dict)
        self._aug_config = _default_aug_config()
        if isinstance(augmentation, dict):
            self._aug_config.update({k: v for k, v in augmentation.items() if v is not None})
        self._meta_base: Optional[Path] = None
        if metadata_cache:
            base = (Path(metadata_cache) if isinstance(metadata_cache, (str, os.PathLike))
                    else self.root_dir / ".cache")
            base.mkdir(parents=True, exist_ok=True)
            self._meta_base = base
        if chunk_cache is None:
            self._chunk_base = self._meta_base
        elif chunk_cache:
            self._chunk_base = Path(chunk_cache)
            self._chunk_base.mkdir(parents=True, exist_ok=True)
        else:
            self._chunk_base = None
        self.subset_dir = self.root_dir / subset
        if not self.subset_dir.exists():
            raise FileNotFoundError(f"Subset directory not found: {self.subset_dir}")
        self.track_infos = self._load_track_metadata()
        if not self.track_infos:
            raise ValueError(f"No tracks found in {self.subset_dir}")
        self._chunk_index: Optional[List[Tuple[int, int]]] = None
        if precompute_chunks:
            if segment_length is None:
                raise ValueError("precompute_chunks requires segment_length")
            self._chunk_index = self._load_or_build_chunk_index()
        self._log(f"Loaded {len(self.track_infos)} tracks from {subset} subset")
        if self._chunk_index is not None:
            self._log(f"Prepared {len(self._chunk_index)} chunk descriptors")

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    # ------------------------------------------------------------ metadata

    def _metadata_cache_path(self) -> Optional[Path]:
        return None if self._meta_base is None else self._meta_base / f"{self.subset}_metadata.pkl"

    def _chunk_cache_path(self) -> Optional[Path]:
        if self._chunk_base is None:
            return None
        return (self._chunk_base
                / f"{self.subset}_sr{self.sample_rate}_seg{self.segment_length or 0}.pkl")

    def _metadata_config(self) -> Dict[str, Any]:
        return {"root": str(self.root_dir), "subset": self.subset,
                "sample_rate": self.sample_rate, "sources": tuple(self.sources)}

    @staticmethod
    def _resolve(directory: Path, stem: str) -> Optional[Path]:
        for ext in FILE_TYPES:
            p = directory / f"{stem}{ext}"
            if p.exists():
                return p
        return None

    def _load_track_metadata(self) -> List[TrackInfo]:
        cache = self._metadata_cache_path()
        if cache and cache.exists():
            try:
                with open(cache, "rb") as fh:
                    payload = pickle.load(fh)
                if (payload.get("version") == CACHE_VERSION
                        and payload.get("config") == self._metadata_config()
                        and "tracks" in payload):
                    return [TrackInfo(t["name"], Path(t["directory"]), t["length"],
                                      t["sample_rate"], t.get("channels", 2), Path(t["mixture"]),
                                      {k: (Path(v) if v else None)
                                       for k, v in t["sources"].items()})
                            for t in payload["tracks"]]
            except Exception:
                self._log(f"Metadata cache at {cache} is invalid, rebuilding...")
        tracks = self._scan()
        if cache:
            payload = {"version": CACHE_VERSION, "config": self._metadata_config(),
                       "tracks": [{"name": t.name, "directory": str(t.directory),
                                   "length": t.length, "sample_rate": t.sample_rate,
                                   "channels": t.channels, "mixture": str(t.mixture_path),
                                   "sources": {k: (str(v) if v else None)
                                               for k, v in t.source_paths.items()}}
                                  for t in tracks]}
            with open(cache, "wb") as fh:
                pickle.dump(payload, fh)
        return tracks

    def _scan(self) -> List[TrackInfo]:
        tracks = []
        for directory in sorted(d for d in self.subset_dir.iterdir() if d.is_dir()):
            mixture = self._resolve(directory, "mixture")
            if mixture is None:
                self._log(f"Skipping {directory.name}: mixture not found")
                continue
            try:
                meta = audio_io.info(str(mixture))
            except ValueError as exc:
                self._log(f"Skipping {directory.name}: {exc}")
                continue
            tracks.append(TrackInfo(directory.name, directory, meta.frames,
                                    meta.sample_rate, meta.channels, mixture,
                                    {s: self._resolve(directory, s) for s in self.sources}))
        return tracks

    # --------------------------------------------------------- chunk index

    def _chunk_config(self) -> Dict[str, Any]:
        return {"sample_rate": self.sample_rate, "segment_length": self.segment_length,
                "chunk_hop": self.chunk_hop, "min_loudness": self.min_loudness,
                "sources": tuple(self.sources)}

    def _load_or_build_chunk_index(self) -> List[Tuple[int, int]]:
        cache = self._chunk_cache_path()
        if cache and cache.exists():
            try:
                with open(cache, "rb") as fh:
                    payload = pickle.load(fh)
                if (payload.get("version") == CACHE_VERSION
                        and payload.get("config") == self._chunk_config()
                        and "chunks" in payload):
                    return payload["chunks"]
            except Exception:
                self._log(f"Chunk cache at {cache} is invalid, rebuilding...")
        chunks = self._build_chunk_index()
        if cache:
            with open(cache, "wb") as fh:
                pickle.dump({"version": CACHE_VERSION, "config": self._chunk_config(),
                             "chunks": chunks}, fh)
        return chunks

    def _build_chunk_index(self) -> List[Tuple[int, int]]:
        """(track index, offset) of every chunk that passes the loudness
        filter, tracks in order; every track's first chunk when none does."""
        chunks: List[Tuple[int, int]] = []
        for idx, track in enumerate(self.track_infos):
            frames = self._frames(track.sample_rate)
            hop = max(int(round((self.chunk_hop if self.chunk_hop is not None
                                 else max(self.segment_length // 2, 1))
                                * track.sample_rate / self.sample_rate)), 1)
            offsets = ([0] if track.length <= frames
                       else list(range(0, track.length - frames + 1, hop)) or [0])
            loud = self._scan_loudness(track, frames, hop, len(offsets))
            if loud is not None:
                chunks += [(idx, off) for off, ok in zip(offsets, loud) if ok]
                continue
            for off in offsets:
                if self._passes_loudness(self._load_chunk(track, off)):
                    chunks.append((idx, off))
        return chunks or [(i, 0) for i in range(len(self.track_infos))]

    def _scan_loudness(self, track: TrackInfo, frames: int, hop: int,
                       n_offsets: int) -> Optional[List[bool]]:
        """Per-offset pass/fail in one pass over each WAV stem (the JAX
        package's native ``wav_scan_meanabs``: float64 prefix sums of |x| over
        frames and channels, windows zero-padded past the end, mean over
        ``frames x channels``); None where a stem is not WAV or the track's
        rate is not the dataset's (the caller reads each chunk)."""
        if self.min_loudness <= 0:
            return [True] * n_offsets
        if track.sample_rate != self.sample_rate:
            return None
        paths = [p for s, p in track.source_paths.items()
                 if s in self.sources and p is not None and p.exists()] or [track.mixture_path]
        if any(audio_io.is_flac(str(p)) for p in paths):
            return None
        best = None
        for p in paths:
            data, _ = audio_io.read(str(p))
            total, ch = data.shape
            prefix = np.concatenate([[0.0], np.cumsum(np.abs(data).astype(np.float64).sum(1))])
            a = np.minimum(np.arange(n_offsets) * hop, total)
            b = np.minimum(a + frames, total)
            mean = (prefix[b] - prefix[a]) / (float(frames) * ch)
            best = mean if best is None else np.maximum(best, mean)
        return [bool(v >= self.min_loudness) for v in best]

    def __len__(self) -> int:
        if self._chunk_index is not None:
            return len(self._chunk_index)
        return len(self.track_infos)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        track = None
        if self.segment_length is None:
            track = self.track_infos[idx % len(self.track_infos)]
            sample = self._load_chunk(track, 0, full=True)
        elif self._chunk_index is not None:
            tidx, off = self._chunk_index[idx % len(self._chunk_index)]
            track = self.track_infos[tidx]
            sample = self._load_chunk(track, off)
        elif self.random_chunks and self.subset == "train":
            sample, track = self._sample_random_chunk()
        else:
            track = self.track_infos[idx % len(self.track_infos)]
            sample = self._load_chunk(track, 0)
        mix_only = False
        if self.augmentation and self.subset == "train":
            sample, mix_only = self._apply_augmentation(sample)
        if self.rebuild_mixture and not mix_only:
            sample["mixture"] = self._sum_stems(sample)
        if self.return_metadata:
            sample["track_name"] = track.name
        return sample

    def _frames(self, sr: int) -> Optional[int]:
        if self.segment_length is None:
            return None
        return max(int(round(self.segment_length * sr / self.sample_rate)), 1)

    def _sample_random_chunk(self):
        """``(sample, track)``: loudness-filtered draws, then the first chunk
        of a random track."""
        for _ in range(self.max_chunk_attempts):
            track = self._rng.choice(self.track_infos)
            frames = self._frames(track.sample_rate)
            off = 0 if track.length <= frames else self._rng.randint(0, track.length - frames)
            sample = self._load_chunk(track, off)
            if self._passes_loudness(sample):
                return sample, track
        track = self._rng.choice(self.track_infos)
        return self._load_chunk(track, 0), track

    def _passes_loudness(self, sample: Dict[str, np.ndarray]) -> bool:
        if self.min_loudness <= 0:
            return True
        stats = [float(np.mean(np.abs(sample[s]))) for s in self.sources if s in sample]
        if not stats:
            stats = [float(np.mean(np.abs(sample["mixture"])))]
        return max(stats) >= self.min_loudness

    def _read(self, path: Path, offset: int, frames: Optional[int]) -> np.ndarray:
        data, sr = audio_io.read(str(path), start=offset, frames=frames)
        audio = data.T  # [C, T]
        if sr != self.sample_rate:
            audio = audio_io.resample(audio.T, sr, self.sample_rate).T
        if self.segment_length is not None and (frames is not None or sr != self.sample_rate):
            audio = _pad_or_trim(audio, self.segment_length)
        return np.ascontiguousarray(audio, dtype=np.float32)

    def _load_chunk(self, track: TrackInfo, offset: int,
                    full: bool = False) -> Dict[str, np.ndarray]:
        frames = None if full else self._frames(track.sample_rate)
        sample = {"mixture": self._read(track.mixture_path, offset, frames)}
        for stem, path in track.source_paths.items():
            if path is None:
                sample[stem] = np.zeros_like(sample["mixture"])
            else:
                sample[stem] = _pad_or_trim(self._read(path, offset, frames),
                                            sample["mixture"].shape[-1])
        return sample

    def _sum_stems(self, sample: Dict[str, np.ndarray]) -> np.ndarray:
        stems = [sample[s] for s in self.sources if s in sample]
        if not stems:
            return sample["mixture"]
        if self.segment_length is not None:
            stems = [_pad_or_trim(a, self.segment_length) for a in stems]
        total = stems[0].copy()
        for a in stems[1:]:
            total = total + a
        return total


    # -------------------------------------------------------- augmentation

    def _apply_augmentation(self, sample):
        """``(sample, mix_only)``: ``mix_only`` when the mixture alone was
        changed (MP3), so it must not be rebuilt from the stems."""
        cfg = self._aug_config
        r = self._rng
        mix_only = False
        loud = cfg.get("loudness")
        if loud:
            low, high = loud
            for stem in self.sources:
                if stem in sample:
                    gain = r.uniform(low, high)
                    sample[stem] = np.clip(sample[stem] * gain, -1.0, 1.0)
        if cfg.get("channel_swap_prob", 0.0) > 0 and r.random() < cfg["channel_swap_prob"]:
            for key, audio in list(sample.items()):
                if isinstance(audio, np.ndarray) and audio.ndim == 2 and audio.shape[0] == 2:
                    sample[key] = audio[::-1].copy()
        if cfg.get("polarity_prob", 0.0) > 0 and r.random() < cfg["polarity_prob"]:
            for key, audio in list(sample.items()):
                if isinstance(audio, np.ndarray):
                    sample[key] = -audio
        mixture = sample.get("mixture")
        if mixture is not None:
            expected = mixture.shape[-1]
            mp3_prob = cfg.get("mp3_prob", 0.0)
            compressor = _mp3_compressor(cfg, r) if mp3_prob > 0 else None
            if compressor is not None and r.random() < mp3_prob:
                out = compressor(samples=mixture.astype(np.float32),
                                 sample_rate=self.sample_rate)
                sample["mixture"] = _pad_or_trim(out, expected).astype(np.float32)
                mix_only = True
            elif cfg.get("noise_prob", 0.0) > 0 and r.random() < cfg["noise_prob"]:
                snr_min, snr_max = cfg.get("noise_snr", (25.0, 40.0))
                snr = r.uniform(snr_min, snr_max)
                power = float(np.mean(mixture ** 2))
                if power > 0:
                    noise_power = power / (10 ** (snr / 10))
                    # seeded from the dataset's generator, never the global one
                    noise_rng = np.random.default_rng(r.getrandbits(64))
                    noise = noise_rng.standard_normal(mixture.shape).astype(np.float32)
                    sample["mixture"] = np.clip(mixture + noise * np.sqrt(noise_power),
                                                -1.0, 1.0)
            target = sample["mixture"].shape[-1]
            for stem in self.sources:
                if stem in sample:
                    sample[stem] = _pad_or_trim(sample[stem], target)
        for stem in self.sources:
            if stem in sample:
                sample[stem] = np.clip(sample[stem], -1.0, 1.0)
        return sample, mix_only


def _mp3_compressor(cfg, r=None):
    """The real MP3 round trip where audiomentations is installed, else the
    codec simulation (``data/codec.py``) with its bitrate and dither drawn
    from the dataset's generator ``r``."""
    lo, hi = cfg.get("mp3_bitrate", (96, 192))
    try:
        import audiomentations as AU
        return AU.Mp3Compression(min_bitrate=int(lo), max_bitrate=int(hi), p=1.0)
    except ImportError:
        pass
    from .codec import mp3_like_compression

    def simulate(samples, sample_rate):
        draw = np.random.default_rng(r.getrandbits(64) if r is not None else None)
        bitrate = float(draw.uniform(lo, hi))
        return mp3_like_compression(samples, sample_rate, bitrate, rng=draw)

    return simulate


def collate_fn(batch: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pad every array to the batch's longest and stack; other values become
    lists."""
    out: Dict[str, Any] = {}
    for key in batch[0]:
        vals = [item[key] for item in batch]
        if isinstance(vals[0], np.ndarray):
            n = max(v.shape[-1] for v in vals)
            out[key] = np.stack([_pad_or_trim(v, n) for v in vals])
        else:
            out[key] = vals
    return out
