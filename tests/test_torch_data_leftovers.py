"""The port's FLAC reads, MUSDB chunk index and metadata cache, and the
``conv1d`` FFN on the CPU, against the JAX package.

* FLAC files from ``tests/flac_writer.py`` (8/16/24-bit, mono and stereo,
  the stereo decorrelation modes): ``info`` and ``read`` (partial reads,
  zero padding past the end) against the JAX ``data/audio_io.py``; the
  speech dataset on a FLAC corpus.  Skipped where ``g++`` is absent (the
  decoder is built from ``native/``).
* ``precompute_chunks`` and the metadata / chunk pickles against the JAX
  ``MUSDBDataset`` on a synthetic tree with silent stretches: the same
  chunk descriptors in the same order and the same samples; a cache hit
  (nothing rescanned), invalidation by version and by config.
* ``ConvDeconv1d`` and a block with ``ffn_type: [conv1d, conv1d]`` against
  the JAX modules on seeded weights carried across by
  ``jax_params_to_state_dict`` (the reference's ``net.0`` / ``net.3`` keys).
"""

import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from flac_writer import write_flac
from mss_tf_locoformer_tpu.data import audio_io as jaudio
from mss_tf_locoformer_tpu.data.musdb import MUSDBDataset as JaxMUSDB
from mss_tf_locoformer_tpu.data.speech import SpeechMixtureDataset as JaxSpeech
from mss_tf_locoformer_tpu.nn.blocks import LocoformerBlock as JaxBlock
from mss_tf_locoformer_tpu.nn.ffn import ConvDeconv1d as JaxConvDeconv
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
from mss_tf_locoformer_tpu_torch.data import audio_io
from mss_tf_locoformer_tpu_torch.data import musdb as M
from mss_tf_locoformer_tpu_torch.data.speech import SpeechMixtureDataset
from mss_tf_locoformer_tpu_torch.nn.blocks import LocoformerBlock
from mss_tf_locoformer_tpu_torch.nn.ffn import ConvDeconv1d

SR = 8000
STEMS = ("vocals", "drums", "bass", "other")
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the FLAC decoder is built from native/ with g++")


def _pcm(rng, frames, ch, bits):
    lim = 1 << (bits - 1)
    return rng.integers(-lim, lim, size=(frames, ch), dtype=np.int64)


@needs_gxx
@pytest.mark.parametrize("bits,ch,assignment,modes", [(8, 1, 0, "fixed2"),
                                                      (16, 2, 0, "fixed1"),
                                                      (16, 2, 10, "verbatim"),
                                                      (24, 2, 8, "verbatim"),
                                                      (24, 1, 0, "verbatim")])
def test_flac_info_and_read_match_jax(tmp_path, rng, bits, ch, assignment, modes):
    data = _pcm(rng, 1500, ch, bits)
    path = str(tmp_path / "a.flac")
    write_flac(path, data, SR, bits=bits, block_size=256, modes=modes, assignment=assignment)
    assert audio_io.info(path) == audio_io.AudioInfo(*jaudio.info(path).__dict__.values())
    for start, n in ((0, None), (0, 100), (255, 300), (1400, 300), (1600, 10)):
        got, sr = audio_io.read(path, start=start, frames=n)
        want, _ = jaudio.read(path, start=start, frames=n)
        assert sr == SR
        np.testing.assert_array_equal(got, want)
    full, _ = audio_io.read(path)
    np.testing.assert_allclose(full, data / float(1 << (bits - 1)), atol=1e-7)


@needs_gxx
def test_speech_dataset_reads_flac_as_jax(tmp_path, rng):
    """The speech dataset lists and reads a FLAC corpus as the JAX one does;
    ``load_audio`` (the CLIs') reads FLAC too."""
    from mss_tf_locoformer_tpu_torch.utils.audio import load_audio
    for d in ("mix", "s1", "s2"):
        (tmp_path / "tr" / d).mkdir(parents=True)
    for u in range(2):
        s1, s2 = (_pcm(rng, 3000, 1, 16) // 4 for _ in range(2))
        for d, x in (("s1", s1), ("s2", s2), ("mix", s1 + s2)):
            write_flac(str(tmp_path / "tr" / d / f"u{u}.flac"), x, SR)
    kw = dict(num_spk=2, sample_rate=SR, segment_length=2000, seed=4)
    ours, theirs = SpeechMixtureDataset(str(tmp_path / "tr"), **kw), \
        JaxSpeech(str(tmp_path / "tr"), **kw)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    audio, sr = load_audio(str(tmp_path / "tr" / "mix" / "u0.flac"))
    assert sr == SR and audio.shape == (1, 3000)
    np.testing.assert_array_equal(audio.T, jaudio.read(str(tmp_path / "tr" / "mix" /
                                                           "u0.flac"))[0])


@pytest.fixture
def musdb_root(tmp_path, rng):
    """4 train tracks of 3 s with silent stretches (the loudness filter
    drops chunks), 1 test track; stereo 16-bit WAV."""
    for subset, tracks, n in (("train", 4, 3 * SR), ("test", 1, SR)):
        for t in range(tracks):
            d = tmp_path / "musdb" / subset / f"track{t}"
            d.mkdir(parents=True)
            stems = {s: (0.1 * rng.standard_normal((n, 2))).astype(np.float32) for s in STEMS}
            for s in STEMS:
                stems[s][(t * SR) // 2:(t * SR) // 2 + SR] = 0.0   # a silent second
            for s, x in stems.items():
                jaudio.write(str(d / f"{s}.wav"), x, SR)
            jaudio.write(str(d / "mixture.wav"), sum(stems.values()), SR)
    return tmp_path / "musdb"


def _kw(**extra):
    return dict(sample_rate=SR, segment_length=SR // 2, sources=list(STEMS), seed=3,
                min_loudness=0.03, verbose=False, precompute_chunks=True, **extra)


def test_chunk_index_matches_jax(musdb_root, tmp_path):
    ours = M.MUSDBDataset(str(musdb_root), "train", chunk_hop=SR // 4,
                          metadata_cache=str(tmp_path / "ours"), **_kw())
    theirs = JaxMUSDB(str(musdb_root), "train", chunk_hop=SR // 4,
                      metadata_cache=str(tmp_path / "jax"), **_kw())
    assert ours._chunk_index == theirs._chunk_index
    assert 4 < len(ours) == len(theirs) < 4 * 11       # silent chunks dropped
    for i in (0, 5, len(ours) - 1):
        a, b = ours[i], theirs[i]
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the default hop (half a segment) and the JAX pickles' plain payloads
    # read by the port
    default = M.MUSDBDataset(str(musdb_root), "train", metadata_cache=str(tmp_path / "jax"),
                             **_kw())
    jdefault = JaxMUSDB(str(musdb_root), "train", metadata_cache=str(tmp_path / "jax"),
                        **_kw())
    assert default._chunk_index == jdefault._chunk_index
    assert default.track_infos == [M.TrackInfo(*t.__dict__.values())
                                   for t in jdefault.track_infos]


def test_caches_hit_and_invalidate(musdb_root, tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    first = M.MUSDBDataset(str(musdb_root), "train", metadata_cache=str(cache), **_kw())
    meta = cache / "train_metadata.pkl"
    chunks = cache / f"train_sr{SR}_seg{SR // 2}.pkl"
    with open(meta, "rb") as f:
        payload = pickle.load(f)
    assert payload["version"] == M.CACHE_VERSION == 2
    assert payload["config"] == {"root": str(musdb_root), "subset": "train",
                                 "sample_rate": SR, "sources": STEMS}
    assert {type(v) for t in payload["tracks"] for v in t.values()} <= {str, int, dict}

    def boom(*a, **k):
        raise AssertionError("rescanned")
    with monkeypatch.context() as mp:   # a cache hit scans and reads nothing
        mp.setattr(M.MUSDBDataset, "_scan", boom)
        mp.setattr(M.MUSDBDataset, "_build_chunk_index", boom)
        hit = M.MUSDBDataset(str(musdb_root), "train", metadata_cache=str(cache), **_kw())
    assert hit._chunk_index == first._chunk_index and hit.track_infos == first.track_infos

    louder = M.MUSDBDataset(str(musdb_root), "train", metadata_cache=str(cache),
                            **dict(_kw(), min_loudness=0.07))   # the chunk config changed
    jlouder = JaxMUSDB(str(musdb_root), "train", metadata_cache=False,
                       **dict(_kw(), min_loudness=0.07))
    assert louder._chunk_index == jlouder._chunk_index != first._chunk_index
    payload["version"] = 1                 # an old version is rescanned
    with open(meta, "wb") as f:
        pickle.dump(payload, f)
    with open(chunks, "rb") as f:
        cp = pickle.load(f)
    with pytest.raises(AssertionError, match="rescanned"):
        with monkeypatch.context() as mp:
            mp.setattr(M.MUSDBDataset, "_scan", boom)
            M.MUSDBDataset(str(musdb_root), "train", metadata_cache=str(cache), **_kw())
    assert cp["config"]["min_loudness"] == 0.07
    two = M.MUSDBDataset(str(musdb_root), "train", metadata_cache=str(cache),
                         **dict(_kw(), sources=["vocals", "bass"]))   # another config
    assert all(set(t.source_paths) == {"vocals", "bass"} for t in two.track_infos)
    assert M.MUSDBDataset(str(musdb_root), "train", metadata_cache=False,
                          **_kw())._chunk_index == first._chunk_index
    assert not (musdb_root / ".cache").exists()
    M.MUSDBDataset(str(musdb_root), "test", sample_rate=SR, verbose=False)
    assert (musdb_root / ".cache" / "test_metadata.pkl").exists()   # the JAX default


@needs_gxx
def test_flac_tree_chunk_index_matches_jax(tmp_path, rng):
    """FLAC stems take the per-chunk loudness reads, as in the JAX dataset."""
    for t in range(2):
        d = tmp_path / "musdb" / "train" / f"t{t}"
        d.mkdir(parents=True)
        stems = {s: _pcm(rng, 2 * SR, 2, 16) // 8 for s in STEMS}
        for s in STEMS:
            stems[s][t * SR // 2:t * SR // 2 + SR // 2] = 0
        for s, x in stems.items():
            write_flac(str(d / f"{s}.flac"), x, SR, block_size=1024)
        write_flac(str(d / "mixture.flac"), sum(stems.values()) // 4, SR, block_size=1024)
    kw = dict(_kw(), min_loudness=0.02)
    ours = M.MUSDBDataset(str(tmp_path / "musdb"), "train", metadata_cache=False, **kw)
    theirs = JaxMUSDB(str(tmp_path / "musdb"), "train", metadata_cache=False, **kw)
    assert ours._chunk_index == theirs._chunk_index and len(ours) > 2
    np.testing.assert_array_equal(ours[1]["vocals"], theirs[1]["vocals"])


def _fill(seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 1:
            return np.float32(path[-1].key != "bias") + 0.1 * z
        return z / np.float32(np.sqrt(np.prod(leaf.shape[1:])))
    return fill


@pytest.mark.parametrize("k,shift", [(4, 1), (3, 2)])
def test_conv1d_ffn_matches_jax(rng, k, shift):
    x = (0.5 * rng.standard_normal((2, 3, 11, 32))).astype(np.float32)
    jmod = JaxConvDeconv(32, 48, k, shift)
    params = jax.tree_util.tree_map_with_path(_fill(k), jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), x))
    # as the block's ffn_0 holds it (the converter reads a block's tree)
    sd = {k[len("ffn.0."):]: v for k, v in jax_params_to_state_dict(
        {"ffn_0": params["params"]}).items()}
    assert sorted(sd) == ["net.0.bias", "net.0.weight", "net.3.bias", "net.3.weight"]
    ours = ConvDeconv1d(32, 48, k, shift, fused=True)
    ours.load_state_dict(sd, strict=True)
    assert not ours.fused
    want = np.asarray(jmod.apply(params, x))
    got = ours(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_conv1d_block_matches_jax(rng):
    """A macaron block of two ``conv1d`` FFNs (norm + FFN + residual, the
    fused FFN flag set but no kernel for this type) and the fused attention
    step, against the JAX block; the keys are the reference's."""
    kw = dict(emb_dim=32, num_groups=4, n_heads=2, attention_dim=32,
              ffn_type=("conv1d", "conv1d"), ffn_hidden_dim=(48, 40), fused_ffn=True,
              flash_attention=True)
    x = (0.5 * rng.standard_normal((2, 3, 13, 32))).astype(np.float32)
    jmod = JaxBlock(**kw)
    params = jax.tree_util.tree_map_with_path(_fill(1), jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), x))
    sd = jax_params_to_state_dict(params)
    assert {"ffn.0.net.0.weight", "ffn.1.net.3.bias"} <= set(sd)
    assert not any(".conv1d." in key or "deconv1d" in key for key in sd)
    block = LocoformerBlock(norm_type="rmsgroupnorm", use_rope=True, conv1d_kernel=4,
                            conv1d_shift=1, eps=1e-5, **kw)
    block.load_state_dict(sd, strict=True)
    assert block.eval().fused_steps() == ([False, False], True)
    assert block.fused_steps(fp32=True) == ([False, False], True)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(params, x)), atol=5e-5, rtol=1e-4)


def test_no_refusal_of_this_slice_left():
    """No module of the port refuses an item of this slice any more: the
    step profiler, FLAC, the chunk index and metadata cache, the conv1d FFN
    and fp32 rows in the fused steps (in the style of
    ``test_torch_parallel.py::test_no_parallel_runs_refusal_left``)."""
    import os
    pkg = os.path.dirname(os.path.dirname(M.__file__))
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                src = open(path).read()
                for phrase in ("not ported yet", "Queue 1: serving leftovers",
                               "Queue 1: training leftovers", "bf16 rows only",
                               "_no_flac", "precompute_chunks {_LATER}"):
                    assert phrase not in src, (path, phrase)
