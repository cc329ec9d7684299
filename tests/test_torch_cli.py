"""The port's surfaces on the CPU: the separation CLI, the config reader (held
against the JAX package's and against the config ``chip_smoke.py`` builds),
checkpoint layouts, WAV I/O, and the rule that the port never imports JAX."""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from mss_tf_locoformer_tpu.core.config import load_config
from mss_tf_locoformer_tpu_torch.cli import separate as cli
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import load_torch_checkpoint
from mss_tf_locoformer_tpu_torch.core.config import ModelConfig, load_model_config
from mss_tf_locoformer_tpu_torch.models import build_model
from mss_tf_locoformer_tpu_torch.utils.audio import load_audio, save_audio
from torch_routes import spy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSS_CONFIGS = sorted(p for p in glob.glob(os.path.join(REPO, "configs", "musdb18*.yaml"))
                     if "bslocoformer" not in p)

# widths the fused steps' gates admit, so that the CLI runs the fused steps
_TINY_YAML = """\
model:
  n_fft: 256
  hop_length: 64
  n_layers: 1
  emb_dim: 32
  num_groups: 4
  n_heads: 2
  attention_dim: 32
  ffn_type: [swiglu_conv1d, swiglu_conv1d]
  ffn_hidden_dim: [32, 32]
  flash_attention: true
  fused_ffn: true
  fused_stft: true
"""


def test_cli_separates_to_four_stems(tmp_path, rng, monkeypatch):
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(_TINY_YAML)
    model = build_model(load_model_config(str(cfg_path)),
                        generator=torch.Generator().manual_seed(0))
    ckpt = tmp_path / "tiny.pth"
    torch.save(model.state_dict(), ckpt)
    sr, n = 8000, 9000            # 3 chunks of 0.5 s with 0.125 s overlap
    wav = tmp_path / "song.wav"
    save_audio(str(wav), (0.3 * rng.standard_normal((2, n))).astype(np.float32), sr)
    out = tmp_path / "out"
    calls = spy(monkeypatch)
    cli.main(["--input", str(wav), "--output_dir", str(out), "--checkpoint",
              str(ckpt), "--config", str(cfg_path), "--device", "cpu",
              "--sample_rate", str(sr), "--chunk_seconds", "0.5",
              "--overlap_seconds", "0.125", "--batch_size", "2"])
    # 2 batches (3 chunks at batch 2) x 2 paths: 2 FFN steps, 1 attention step
    assert calls == {"fused_norm_ffn_residual": 8, "fused_attention_block": 4,
                     "swiglu_conv_deconv": 0, "flash_attention": 0}
    for stem in ("vocals", "drums", "bass", "other"):
        audio, rate = load_audio(str(out / f"song_{stem}.wav"))
        assert rate == sr and audio.shape == (2, n)
        assert np.isfinite(audio).all() and np.abs(audio).max() > 0
        np.testing.assert_array_equal(audio[0], audio[1])   # mono stem, duplicated


def test_cli_requires_a_device(tmp_path):
    """No silent CPU: the CLIs and the serving API run on the card unless the
    caller asks for the CPU."""
    from mss_tf_locoformer_tpu_torch.cli import train as train_cli
    from mss_tf_locoformer_tpu_torch.infer.separate import make_engine
    args = ["--input", "a.wav", "--checkpoint", "m.pth"]
    assert cli.parse_args(args).device == "cuda"
    assert cli.parse_args(args + ["--device", "cpu"]).device == "cpu"
    assert train_cli.parse_args(["--config", "c.json"]).device == "cuda"
    model = build_model(ModelConfig(n_fft=256, hop_length=64, n_layers=1, emb_dim=32,
                                    attention_dim=32, n_heads=2, ffn_hidden_dim=32))
    assert make_engine(model).device.type == "cuda"
    assert make_engine(model, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("path", MSS_CONFIGS, ids=os.path.basename)
def test_model_config_matches_jax(path):
    ours = dataclasses.asdict(load_model_config(path))
    theirs = dataclasses.asdict(load_config(path).model)
    assert ours == theirs


def test_chip_smoke_builds_the_base_config():
    base = load_model_config(os.path.join(REPO, "configs", "musdb18.yaml"))
    assert chip_smoke.base_model_config() == base


def test_model_config_rejects_unknown_keys(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("model:\n  emb_dim: 16\n  n_layrs: 2\n")
    with pytest.raises(ValueError, match="n_layrs"):
        load_model_config(str(path))


def test_json_config_needs_no_yaml(tmp_path):
    import json
    cfg = ModelConfig(n_layers=2, emb_dim=32)
    path = tmp_path / "model.json"
    path.write_text(json.dumps({"model": dataclasses.asdict(cfg)}))
    assert load_model_config(str(path)) == cfg


@pytest.mark.parametrize("layout", ["raw", "trainer", "espnet"])
def test_checkpoint_layouts(tmp_path, layout):
    sd = {"deconv.bias": torch.arange(4.0), "conv.0.weight": torch.ones(2, 2)}
    blob = {"raw": sd,
            "trainer": {"model_state_dict": sd, "epoch": 3},
            "espnet": {**{f"separator.{k}": v for k, v in sd.items()},
                       "encoder.x": torch.zeros(1)}}[layout]
    torch.save(blob, tmp_path / "m.pth")
    got = load_torch_checkpoint(str(tmp_path / "m.pth"))
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k])


def test_wav_roundtrip_and_resample(tmp_path, rng):
    x = (0.5 * rng.standard_normal((2, 4410))).astype(np.float32)
    path = str(tmp_path / "x.wav")
    save_audio(path, x, 44100, normalize=False, bits=32)
    y, sr = load_audio(path)
    assert sr == 44100
    np.testing.assert_array_equal(y, x)
    z, sr = load_audio(path, sample_rate=22050, mono=True)
    assert sr == 22050 and z.shape == (1, 2205)


def test_port_imports_no_jax():
    """Every module of the port (and chip_smoke.py) imports without JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mss_tf_locoformer_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mss_tf_locoformer_tpu.')))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
