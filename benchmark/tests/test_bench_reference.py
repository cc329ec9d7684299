"""The plain reference against the port's plain CPU path at tiny shapes,
the Philox copy against the port's masks, and the trace reduction.

    python -m pytest benchmark/tests/test_bench_reference.py -q
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import trace as T  # noqa: E402
from benchmark.reference import philox  # noqa: E402
from benchmark.reference import tflocoformer_mss as R  # noqa: E402

TINY = dict(name="tflocoformer_mss", n_fft=256, hop_length=64, n_sources=4, n_layers=2,
            emb_dim=16, norm_type="rmsgroupnorm", num_groups=4, tf_order="ft", n_heads=2,
            flash_attention=True, fused_ffn=True, fused_stft=True, attention_dim=16,
            pos_enc="rope", ffn_type=["swiglu_conv1d", "swiglu_conv1d"],
            ffn_hidden_dim=[32, 24], conv1d_kernel=4, conv1d_shift=1, dropout=0.1, eps=1e-5)


def _port(m, w):
    from mss_tf_locoformer_tpu_torch.core.config import model_config_from_dict
    from mss_tf_locoformer_tpu_torch.core.precision import FP32
    from mss_tf_locoformer_tpu_torch.models import build_model
    model = build_model(model_config_from_dict(m), FP32)
    model.load_state_dict(w, strict=True)
    return model


@pytest.mark.parametrize("site,a,c,b,p", [(1, 9, 1, 6, 0.3), (3, 4, 7, 13, 0.1),
                                          (2, 5, 1, 16, 0.1)])
def test_philox_copy_is_the_ports_mask(site, a, c, b, p):
    from mss_tf_locoformer_tpu_torch.ops import dropout as D
    rows = torch.arange(3, 11)
    got = philox.keep(2 ** 31 - 5, site, rows, a, c, b, p)
    want = D.keep_mask(2 ** 31 - 5, site, rows[:, None, None, None],
                       torch.arange(a)[None, :, None, None], torch.arange(b)[None, None, None, :],
                       torch.arange(c)[None, None, :, None], p=p)
    assert torch.equal(got, want)


def test_reference_forward_is_the_ports():
    w = R.make_weights(TINY, 7, "cpu")
    model = _port(TINY, w).eval()
    x = torch.randn(2, 4000, generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        got, want = model(x), R.Reference(TINY, w)(x)
    for k in want:
        assert torch.allclose(got[k], want[k], rtol=0, atol=1e-6 * want[k].abs().max())


def test_reference_training_step_is_the_ports():
    """Loss and gradients of a micro-batch with dropout: the same masks."""
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig
    from mss_tf_locoformer_tpu_torch.losses.mss_loss import mss_loss
    w = R.make_weights(TINY, 8, "cpu")
    model = _port(TINY, w).train()
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 4000, generator=g) * 0.1
    tgt = {s: torch.randn(2, 4000, generator=g) * 0.05 for s in R.SOURCES}
    got = mss_loss(model(x, generator=torch.Generator().manual_seed(5)), tgt, LossConfig())
    got["total_loss"].backward()
    ref = R.Reference(TINY, {k: v.clone().requires_grad_(True) for k, v in w.items()})
    want = R.loss(ref(x, torch.Generator().manual_seed(5), 0.1), tgt, {})
    want["total_loss"].backward()
    assert set(want) == set(got)
    for k in want:
        assert float(got[k].detach()) == pytest.approx(float(want[k].detach()), rel=1e-5), k
    for name, p in model.named_parameters():
        r = ref.w[name].grad
        assert float((p.grad - r).norm() / r.norm()) < 1e-5, name


def test_trace_reduction_counts_overlap_once_and_names_gaps():
    ev = [{"name": "bench.traced", "ph": "X", "cat": "user_annotation", "ts": 0, "dur": 100},
          {"name": "bench.song", "ph": "X", "cat": "user_annotation", "ts": 0, "dur": 100},
          {"name": "bench.model_call", "ph": "X", "cat": "user_annotation", "ts": 10, "dur": 40},
          {"name": "k1", "ph": "X", "cat": "kernel", "ts": 12, "dur": 20},
          {"name": "k2", "ph": "X", "cat": "kernel", "ts": 20, "dur": 20},
          {"name": "cp", "ph": "X", "cat": "gpu_memcpy", "ts": 60, "dur": 10}]
    s = T.reduce(ev, {"bench.song": "engine", "bench.model_call": "model"})
    assert s.busy_s == pytest.approx(38e-6) and s.window_s == pytest.approx(100e-6)
    assert s.kernel_s == pytest.approx(40e-6)
    assert s.idle_gaps[0] == ["engine", pytest.approx(30e-6)]
    assert s.idle_gaps[1] == ["model", pytest.approx(20e-6)]
