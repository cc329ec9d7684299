"""The port's counter-based dropout (``ops/dropout.py``, the bits of
``csrc/philox.cuh``) and the dropout of the plain fused steps, on the CPU.
The JAX package's masks come from the TPU's own generator and cannot be
matched, so nothing here compares with JAX."""

import math

import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu_torch.ops import dropout as D
from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB

SITES = (D.SITE_FFN_INNER, D.SITE_FFN_OUTER, D.SITE_ATTN_PROB, D.SITE_ATTN_PROJ)


def test_philox_matches_the_published_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    z = torch.zeros(1, dtype=torch.int64)
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    pi = [torch.tensor([v]) for v in (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)]
    cases = [((z, z, z, z), 0, 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((f, f, f, f), 0xFFFFFFFF, 0xFFFFFFFF,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             (pi, 0xA4093822, 0x299F31D0, (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, k0, k1, want in cases:
        assert tuple(int(w) for w in D.philox4x32_10(*ctr, k0, k1)) == want


@pytest.mark.parametrize("site", SITES)
def test_keep_rate_within_four_sigma(site):
    p, n_rows, a, b = 0.1, 16, 256, 256            # 1,048,576 draws
    keep = D.keep_mask(12345, site, torch.arange(n_rows)[:, None, None],
                       torch.arange(a)[None, :, None], torch.arange(b)[None, None], p=p)
    n = keep.numel()
    sigma = math.sqrt(n * p * (1 - p))
    assert abs(int(keep.sum()) - n * (1 - p)) < 4 * sigma


def test_row_slice_gives_the_rows_of_a_full_call():
    full = D.keep_mask(7, D.SITE_ATTN_PROB, torch.arange(40).reshape(-1, 1, 1, 1),
                       torch.arange(3)[None, :, None, None], torch.arange(37)[None, None, None],
                       torch.arange(37)[None, None, :, None], p=0.1)
    part = D.keep_mask(7, D.SITE_ATTN_PROB, torch.arange(11, 19).reshape(-1, 1, 1, 1),
                       torch.arange(3)[None, :, None, None], torch.arange(37)[None, None, None],
                       torch.arange(37)[None, None, :, None], p=0.1)
    assert torch.equal(full[11:19], part)


def test_chunked_generation_equals_one_piece(monkeypatch):
    args = (3, D.SITE_FFN_INNER, torch.arange(9)[:, None, None],
            torch.arange(50)[None, :, None], torch.arange(64)[None, None])
    whole = D.keep_mask(*args, p=0.2)
    monkeypatch.setattr(D, "_CHUNK", 1000)
    assert torch.equal(D.keep_mask(*args, p=0.2), whole)


def test_sites_and_seeds_are_decorrelated():
    """Two sites (and two seeds) at the same index: the masks agree only as
    often as independent masks would (P = 0.9^2 + 0.1^2 = 0.82)."""
    idx = (torch.arange(16)[:, None, None], torch.arange(128)[None, :, None],
           torch.arange(128)[None, None])
    masks = [D.keep_mask(99, s, *idx, p=0.1) for s in SITES]
    masks.append(D.keep_mask(100, SITES[0], *idx, p=0.1))
    n = masks[0].numel()
    sigma = math.sqrt(n * 0.82 * 0.18)
    for i in range(len(masks)):
        for j in range(i + 1, len(masks)):
            agree = int((masks[i] == masks[j]).sum())
            assert abs(agree - 0.82 * n) < 5 * sigma, (i, j)


def _ffn_args(rng, r, seq, c, inner, k):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return [t(rng.standard_normal((r, seq, c))), t(1 + 0.1 * rng.standard_normal(c)),
            t(0.2 * rng.standard_normal((2 * inner, c, k))), t(0.1 * rng.standard_normal(2 * inner)),
            t(0.2 * rng.standard_normal((inner, c, k))), t(0.1 * rng.standard_normal(c))]


def test_plain_ffn_step_dropout_by_hand(rng):
    """The plain FFN step at p > 0 equals a hand-written computation with
    the same masks, forward and backward."""
    r, seq, c, inner, k, p, seed, row0 = 3, 23, 16, 32, 4, 0.25, 17, 5
    args = [a.requires_grad_(True) for a in _ffn_args(rng, r, seq, c, inner, k)]
    got = FB.reference_norm_ffn_residual(*args, k, 4, 1e-5, p, seed, row0)
    x, gamma, cw, cb, dw, db = args
    rows = torch.arange(row0, row0 + r)
    m_in = D.keep_mask(seed, D.SITE_FFN_INNER, rows[:, None, None],
                       torch.arange(seq + k - 1)[None, :, None], torch.arange(inner)[None, None], p=p)
    m_out = D.keep_mask(seed, D.SITE_FFN_OUTER, rows[:, None, None],
                        torch.arange(seq)[None, :, None], torch.arange(c)[None, None], p=p)
    g = x.reshape(r, seq, 4, c // 4)
    xn = (g / (g.pow(2).mean(-1, keepdim=True).sqrt() + 1e-5)).reshape(r, seq, c) * gamma
    xp = torch.nn.functional.pad(xn, (0, 0, k - 1, k - 1))                # [R, L+2(k-1), C]
    y = sum(xp[:, t:t + seq + k - 1] @ cw[:, :, t].T for t in range(k)) + cb
    h = y[..., :inner] * torch.nn.functional.silu(y[..., inner:])
    h = h * m_in / (1 - p)
    zp = torch.zeros(r, seq + 2 * (k - 1), c)
    for t in range(k):
        zp = zp + torch.nn.functional.pad(h @ dw[:, :, t], (0, 0, t, k - 1 - t))
    z = (zp[:, k - 1:k - 1 + seq] + db) * m_out / (1 - p)
    want = x + z
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    cot = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    ga = torch.autograd.grad(got, args, cot)
    gb = torch.autograd.grad(want, args, cot)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_plain_attention_step_dropout_by_hand(rng):
    """The plain attention step at p > 0: probabilities dropped after
    normalising, then the out-projection mask, forward and backward."""
    r, seq, c, a, h, p, seed, row0 = 2, 19, 16, 16, 2, 0.3, 5, 9
    t = lambda v: torch.from_numpy(np.asarray(v, np.float32)).requires_grad_(True)
    x, gamma = t(0.5 * rng.standard_normal((r, seq, c))), t(1 + 0.1 * rng.standard_normal(c))
    wqkv, wout = t(rng.standard_normal((3 * a, c)) / 4), t(rng.standard_normal((c, a)) / 4)
    got = AB.reference_attention_block(x, gamma, wqkv, wout, h, 4, 1e-5, False,
                                       10000.0, p, seed, row0)
    rows = torch.arange(row0, row0 + r)
    keep_p = AB.probability_mask(seed, rows, h, seq, p)
    keep_o = D.keep_mask(seed, D.SITE_ATTN_PROJ, rows[:, None, None],
                         torch.arange(seq)[None, :, None], torch.arange(c)[None, None], p=p)
    g = x.reshape(r, seq, 4, c // 4)
    xn = (g / (g.pow(2).mean(-1, keepdim=True).sqrt() + 1e-5)).reshape(r, seq, c) * gamma
    q, k, v = (xn @ wqkv.T).reshape(r, seq, 3, h, a // h).permute(2, 0, 3, 1, 4)
    prob = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(a // h), -1)
    o = ((prob * keep_p / (1 - p)) @ v).transpose(1, 2).reshape(r, seq, a)
    want = x + (o @ wout.T) * keep_o / (1 - p)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    cot = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    for ga, gb in zip(torch.autograd.grad(got, (x, gamma, wqkv, wout), cot),
                      torch.autograd.grad(want, (x, gamma, wqkv, wout), cot)):
        torch.testing.assert_close(ga, gb, atol=1e-5, rtol=1e-5)


def test_fused_and_unfused_models_drop_the_same(rng):
    """In training mode the kernel path (here its plain versions) and the
    unfused modules draw the same seeds and apply the same masks."""
    import dataclasses

    from mss_tf_locoformer_tpu_torch.core.config import ModelConfig
    from mss_tf_locoformer_tpu_torch.models import build_model
    # emb 32: a width the fused steps' gates admit, so the kernel path is the
    # fused steps (ops/cuda/swiglu_block.py::supports_step, supports_block)
    cfg = ModelConfig(n_fft=256, hop_length=64, n_layers=1, emb_dim=32, num_groups=4,
                      n_heads=2, attention_dim=32,
                      ffn_type=("swiglu_conv1d", "swiglu_conv1d"), ffn_hidden_dim=(32, 32),
                      dropout=0.1, fused_ffn=True, flash_attention=True)
    fused = build_model(cfg).train()
    plain = build_model(dataclasses.replace(cfg, fused_ffn=False, flash_attention=False)).train()
    plain.load_state_dict(fused.state_dict())
    x = torch.from_numpy((0.3 * rng.standard_normal((2, 3000))).astype(np.float32))
    a = fused(x, generator=torch.Generator().manual_seed(1))
    b = plain(x, generator=torch.Generator().manual_seed(1))
    c = plain(x, generator=torch.Generator().manual_seed(2))
    ev = fused.eval()(x)
    for name in a:
        torch.testing.assert_close(a[name], b[name], atol=1e-6, rtol=1e-6)
        assert not torch.allclose(a[name], c[name])
        assert not torch.allclose(a[name], ev[name])
    with pytest.raises(ValueError, match="Generator"):
        fused.train()(x)
