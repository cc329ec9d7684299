"""The port's leg of the north-star pipeline test (``tests/test_north_star.py``
is the JAX package's): the port's chunked overlap-add ``SeparationEngine``
around its ``TFLocoformerMSS`` (the fused steps' and the STFT's plain
versions here) against the JAX engine around the JAX model, with the same
weights (``jax_params_to_state_dict``) on the same synthetic 4-stem track,
at a tiny geometry: chunks of 1.5 s with 0.375 s of overlap over 4.1 s (3
seams and a zero-padded tail) in batches of 3, and the whole track as one
chunk.  Per stem: SI-SDR(port, JAX) >= 40 dB, and SI-SDR against the target
within 0.1 dB of the JAX stem's."""

import jax
import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu.core.config import ModelConfig as JaxConfig
from mss_tf_locoformer_tpu.eval.metrics import compute_si_sdr as jax_si_sdr
from mss_tf_locoformer_tpu.infer.overlap_add import SeparationEngine as JaxEngine
from mss_tf_locoformer_tpu.models.mss_tflocoformer import TFLocoformerMSS as JaxMSS
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
from mss_tf_locoformer_tpu_torch.core.config import ModelConfig
from mss_tf_locoformer_tpu_torch.eval.metrics import compute_si_sdr
from mss_tf_locoformer_tpu_torch.infer.overlap_add import SeparationEngine
from mss_tf_locoformer_tpu_torch.models import build_model

STEMS = ("vocals", "drums", "bass", "other")
SR = 8000
KW = dict(n_fft=256, hop_length=64, n_sources=4, n_layers=1, emb_dim=32, num_groups=4,
          n_heads=2, attention_dim=32, ffn_type=("swiglu_conv1d", "swiglu_conv1d"),
          ffn_hidden_dim=(32, 32))


def _track(rng, seconds):
    """The north-star test's synthetic stems: vibrato sine, gated noise, low
    sine, smoothed noise."""
    t = int(SR * seconds)
    ts = np.arange(t) / SR
    am = 0.5 * (1.2 + np.sin(2 * np.pi * 0.7 * ts))
    n = rng.standard_normal(t + 8)
    stems = {"vocals": 0.22 * am * np.sin(2 * np.pi * 261.6 * ts
                                          + 0.15 * np.sin(2 * np.pi * 2.3 * ts)),
             "drums": 0.2 * (n[:-8] - n[8:]) * (np.sin(2 * np.pi * 2.0 * ts) > 0.3),
             "bass": 0.25 * np.sin(2 * np.pi * 55.0 * ts),
             "other": 0.15 * np.convolve(rng.standard_normal(t), np.ones(16) / 16, "same")}
    stems = {k: v.astype(np.float32) for k, v in stems.items()}
    return sum(stems.values()).astype(np.float32), stems


@pytest.mark.parametrize("chunk_s,overlap_s", [(1.5, 0.375), (None, 0.0)])
def test_port_engine_matches_jax_engine(rng, chunk_s, overlap_s):
    mixture, targets = _track(rng, 4.1)
    chunk = mixture.shape[-1] if chunk_s is None else int(chunk_s * SR)
    overlap = int(overlap_s * SR)
    if chunk_s is not None:
        assert (mixture.shape[-1] - chunk) % (chunk - overlap) != 0   # a padded tail

    jmodel = JaxMSS(JaxConfig(**KW))
    # seeded values on the tree's shapes (an op-by-op init costs a compile
    # per op): scales 1 + 0.1 N, biases 0.1 N, weights N(0, 1 / fan_in)
    fill_rng = np.random.default_rng(3)

    def fill(path, leaf):
        z = fill_rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 1:
            return np.float32(path[-1].key != "bias") + 0.1 * z
        return z / np.float32(np.sqrt(np.prod(leaf.shape[1:])))
    params = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(3), mixture[None, :chunk]))
    apply = jax.jit(lambda m: jmodel.apply(params, m))
    want = JaxEngine(apply, chunk_samples=chunk, overlap=overlap, batch_size=3)(mixture)

    model = build_model(ModelConfig(**KW, fused_ffn=True, flash_attention=True,
                                    fused_stft=True))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    model.eval()

    def run(m):
        with torch.no_grad():
            return model(m)
    got = SeparationEngine(run, chunk_samples=chunk, overlap=overlap, batch_size=3,
                           device="cpu")(mixture)
    assert set(got) == set(want) == set(STEMS)
    for k in STEMS:
        assert got[k].shape == mixture.shape
        agree = compute_si_sdr(got[k], want[k])
        assert agree >= 40.0, (k, agree)
        ours, theirs = compute_si_sdr(got[k], targets[k]), compute_si_sdr(want[k], targets[k])
        assert abs(ours - theirs) <= 0.1, (k, ours, theirs)
        assert theirs == pytest.approx(jax_si_sdr(want[k], targets[k]), abs=1e-6)
