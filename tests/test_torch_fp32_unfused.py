"""fp32 rows of the unfused route's kernels (#6-#9, ``ops/cuda/unfused_fp32.py``)
on the CPU, against the JAX package.

* The four chains run on the kernels' arithmetic emulated in plain torch
  (``TorchPrims`` of ``tests/test_torch_fp32_steps.py``: the windowed GEMMs
  and their epilogues, the split partials and their fixed-order sums, the
  RoPE split and the attention core) against the JAX ``flash_attention`` /
  ``_flash_backward_pallas`` and ``swiglu_conv_deconv`` / ``_backward_pallas``
  at fp32 in interpret mode; with dropout and in row groups against the
  port's plain version (the JAX kernels draw other masks).
* The fp32 gates and the launches' bytes, against the bf16 gates.
* The routes an fp32 model's modules take (``tests/torch_routes.py``), and
  the wrappers' card branch (the autograd Functions and their counters) run
  on CPU tensors with the emulated kernels: an fp32 small-structure model's
  ``use_amp: false`` AdamW step through it against ``make_train_step``.
* The CUDA dispatch by dtype (stubbed): fp32 to the fp32 kernels, fp16
  refused.

The kernels' own arithmetic is held on the card (``chip_smoke.py``,
``tests/test_torch_cuda_kernels.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu_torch.core import config as C
from mss_tf_locoformer_tpu_torch.nn.blocks import LocoformerBlock
from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
from test_torch_fp32_steps import TOL, TorchPrims
from torch_routes import spy

from mss_tf_locoformer_tpu.ops.pallas import flash_attention as JFA
from mss_tf_locoformer_tpu.ops.pallas import swiglu_ffn as JFFN

REL_L2 = 1e-4     # gradients: sums over every position in another order
STEMS = ("vocals", "drums", "bass", "other")
# the small config's structure (C 48, 4 heads of 12, one FFN of I 192, k
# 4): refused by the fused steps' gates in both dtypes, so every step is
# unfused
SMALL = dict(emb_dim=48, num_groups=4, n_heads=4, attention_dim=48, ffn_type="swiglu_conv1d",
             ffn_hidden_dim=192, conv1d_kernel=4, conv1d_shift=1, fused_ffn=True,
             flash_attention=True)


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL:g} x {scale:.3e}"


def _rel(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= REL_L2, f"{what}: relative L2 {rel:.3e}"


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


# ----------------------------------------------- #6 and #7 against JAX

# (L, D, RoPE, views): L 1 and the 65- and 129-position tails of the
# 64-row tiles, D 12 and 16 (both at DP 16), q, k and v as the MHSA's views
# of one QKV product or as tensors of their own (the wrapper's copy)
FLASH_CASES = [(1, 12, True, True), (65, 16, False, True), (129, 12, False, False),
               (129, 16, True, True), (65, 12, True, False), (1, 16, False, False)]


@pytest.mark.parametrize("seq,d,rope,views", FLASH_CASES)
def test_flash_chain_matches_jax(rng, seq, d, rope, views):
    b, h = 2, 2
    qkv = (0.7 * rng.standard_normal((b, seq, 3, h, d))).astype(np.float32)
    g = rng.standard_normal((b, h, seq, d)).astype(np.float32)
    q, k, v = _t(qkv).permute(2, 0, 3, 1, 4)
    if not views:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        assert U._qkv_rows(q, k, v).data_ptr() != q.data_ptr()
    else:
        assert U._qkv_rows(q, k, v).data_ptr() == q.data_ptr()   # no copy
    prims = TorchPrims()
    out, lse = U.flash_forward_fp32(q, k, v, rope, 10000.0, True, prims=prims)
    assert out.shape == (b, seq, h, d) and lse.shape == (b, h, seq)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(t.numpy())) for t in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JFA.flash_attention(jq, jk, jv, rope))
        wgrads = JFA._flash_backward_pallas(jq, jk, jv, jnp.asarray(g), rope, 10000.0)
    _close(out.permute(0, 2, 1, 3), want, "out")
    grads = U.flash_backward_fp32(_t(g).permute(0, 2, 1, 3), q, k, v, out, lse, rope, 10000.0,
                                  prims=prims)
    for name, a, w in zip(("dq", "dk", "dv"), grads, wgrads):
        assert a.shape == (b, h, seq, d)
        w = np.asarray(w)
        if seq == 1 and name != "dv":   # softmax over one key: no gradient to q, k
            assert np.abs(a.numpy()).max() < 1e-6 and np.abs(w).max() < 1e-6
        else:
            _rel(a, w, name)
    assert prims.calls == {"qkv_split": 2, "attn_fwd": 1, "attn_bwd": 1}


# ----------------------------------------------- #8 and #9 against JAX

# (rows, L, C, I, k): the small config's widths, C 64, a C 256 row slice at
# the xlarge inner width, and an inner width padded to whole float4s
CORE_CASES = [(3, 19, 48, 192, 4), (2, 11, 64, 192, 4), (1, 7, 256, 1024, 4),
              (2, 9, 48, 30, 3)]


@pytest.mark.parametrize("r,seq,c,inner,k", CORE_CASES)
def test_ffn_core_chain_matches_jax(rng, r, seq, c, inner, k):
    lin = seq + 2 * (k - 1)
    x = np.zeros((r, lin, c), np.float32)           # pre-padded rows
    x[:, k - 1:k - 1 + seq] = rng.standard_normal((r, seq, c))
    bound = (c * k) ** -0.5
    w = [rng.uniform(-bound, bound, s).astype(np.float32)
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    g = rng.standard_normal((r, lin, c)).astype(np.float32)
    prims = TorchPrims()
    out = U.ffn_core_fp32(_t(x), *map(_t, w), k, prims=prims)
    grads = U.ffn_core_fp32_backward(_t(g), _t(x), *map(_t, w[:3]), k, prims=prims)
    jargs = [jnp.asarray(a) for a in (x, *w)]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JFFN.swiglu_conv_deconv(*jargs, k))
        wgrads = JFFN._backward_pallas(*jargs, k, jnp.asarray(g))
    _close(out, want, "out")
    names = ("dx", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b")
    for name, a, wg in zip(names, grads, wgrads):
        assert a.shape == np.shape(wg), name
        (_close if name == "dx" else _rel)(a, np.asarray(wg), name)


# (rows, L, C, I, k, dropout, scratch cap): one row group, and groups of
# one row (the cap of one row's scratch) with both inner widths
GROUP_CASES = [(3, 17, 48, 192, 4, 0.1, U.SCRATCH_CAP), (3, 17, 48, 192, 4, 0.2, 1),
               (4, 6, 16, 30, 3, 0.3, 1)]


@pytest.mark.parametrize("r,seq,c,inner,k,p,cap", GROUP_CASES)
def test_ffn_core_chain_dropout_and_row_groups(rng, r, seq, c, inner, k, p, cap):
    """The inner mask at ``inner_mask``'s coordinates (rows offset by 5) in
    row groups, against autograd through the plain version."""
    lin = seq + 2 * (k - 1)
    x = torch.zeros(r, lin, c)
    x[:, k - 1:k - 1 + seq] = _t(rng.standard_normal((r, seq, c)))
    bound = (c * k) ** -0.5
    w = [_t(rng.uniform(-bound, bound, s))
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    g = _t(rng.standard_normal((r, lin, c)))
    groups = -(-r // U.core_rows(r, lin, c, inner, k, True, cap))
    assert groups == (1 if cap == U.SCRATCH_CAP else r)
    leaves = [t.clone().requires_grad_(True) for t in (x, *w)]
    ref_out = SF.reference_swiglu_conv_deconv(*leaves, k, p, 99, 5)
    ref = torch.autograd.grad(ref_out, leaves, g)
    prims = TorchPrims()
    out = U.ffn_core_fp32(x, *w, k, p, 99, 5, prims=prims, scratch_cap=cap)
    got = U.ffn_core_fp32_backward(g, x, *w[:3], k, p, 99, 5, prims=prims, scratch_cap=cap)
    _close(out, ref_out.detach(), "out")
    for name, a, b in zip(("dx", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b"), got, ref):
        (_close if name == "dx" else _rel)(a, b, name)
    assert prims.calls["gemm_nn"] == 5 * groups and prims.calls["gemm_tn"] == 2 * groups


# ---------------------------------------------------------------- gates

def test_fp32_gates_admit_what_the_bf16_gates_admit():
    """The fp32 gates take every head_dim and FFN-core shape the bf16 gates
    take (and inner widths of any size, padded in the panels); fp16 is no
    kernel's dtype.  The launches' bytes are pinned."""
    for d in range(0, 70):
        assert FA.supports_shape(d, torch.float32) == FA.supports_shape(d), d
        assert not FA.supports_shape(d, torch.float16)
    for c in range(4, 300, 4):
        for inner in (1, 30, 64, 192, 1024):
            for k in range(1, 10):
                for training in (False, True):
                    bf = SF.supports_shape(c, inner, k, training)
                    fp = SF.supports_shape(c, inner, k, training, torch.float32)
                    assert fp >= bf and fp == (2 <= k <= 8), (c, inner, k, training)
                    assert not SF.supports_shape(c, inner, k, training, torch.float16)
    assert [U.head_pad(d) for d in (2, 12, 16, 18, 32, 34, 64)] == [16, 16, 16, 32, 32, 64, 64]
    assert U.flash_launch_bytes(12) == U.flash_launch_bytes(16) == {"attn": 30720,
                                                                      "dkdv": 32256}
    assert U.flash_launch_bytes(24) == {"attn": 55296, "dkdv": 56832}
    assert U.flash_launch_bytes(64) == {"attn": 104448, "dkdv": 105984}
    assert U.core_launch_bytes() == {"nn": 197632, "nn64": 132096, "tn": 104448}
    # the small config's freq path at its training micro-batch: 16 row
    # groups of <= 1 GiB of fp32 scratch
    assert U.core_rows(8272, 519, 48, 192, 4, True) == 541
    assert U.core_rows(690, 2055, 256, 1024, 4, False) == 127   # xlarge serving freq


# ---------------------------------------------------------------- routes

@pytest.mark.parametrize("name,c,groups,h,inner,ffns", [("xlarge", 256, 8, 16, 1024, 2),
                                                        ("small", 48, 4, 4, 192, 1)])
def test_fp32_blocks_take_the_unfused_kernels(monkeypatch, name, c, groups, h, inner, ffns):
    """fp32 blocks of the xlarge and small configs' structures (macaron or
    one FFN): no fused step (the step gates refuse C 256 and C 48 in both
    dtypes), the core of each step on the flash-attention and FFN-core
    kernels, in eval and in training (dropout 0)."""
    macaron = ffns == 2
    block = LocoformerBlock(
        emb_dim=c, norm_type="rmsgroupnorm", num_groups=groups, n_heads=h,
        flash_attention=True, attention_dim=c, use_rope=True,
        ffn_type=("swiglu_conv1d",) * 2 if macaron else "swiglu_conv1d",
        ffn_hidden_dim=(inner, inner) if macaron else inner, conv1d_kernel=4,
        conv1d_shift=1, fused_ffn=True, eps=1e-5)
    calls = spy(monkeypatch)
    x = torch.randn(2, 3, 9, c, generator=torch.Generator().manual_seed(1))
    for training in (False, True):
        block.train(training)
        assert block.fused_steps(fp32=True) == ([False] * ffns, False)
        assert block.attn._flash[True] and all(f._fused[training, True] for f in block.ffn)
        block(x, generator=torch.Generator().manual_seed(2))
    assert calls == {"fused_norm_ffn_residual": 0, "fused_attention_block": 0,
                     "swiglu_conv_deconv": 2 * ffns, "flash_attention": 2}


@pytest.fixture
def emulated_card(monkeypatch):
    """The wrappers' card branch on CPU tensors: ``flash_attention`` and
    ``swiglu_conv_deconv`` through their checks and autograd Functions, the
    fp32 chains on the kernels' arithmetic in plain torch; returns the
    emulated kernels' call counts."""
    prims = TorchPrims()
    monkeypatch.setattr(S, "_CUDA", [prims])

    def flash(q, k, v, rope=False, theta=10000.0):
        FA._check(q, k, v)
        out = FA.FlashAttention.apply(FA._as4(q), FA._as4(k), FA._as4(v), bool(rope),
                                      float(theta))
        return out.permute(0, 2, 1, 3).reshape(q.shape)

    def core(x, conv_w, conv_b, deconv_w, deconv_b, kernel, drop_rate=0.0, seed=0, row0=0):
        SF._check(x, conv_w, conv_b, deconv_w, deconv_b, kernel)
        return SF.SwiGLUCore.apply(x, conv_w, conv_b, deconv_w, deconv_b, kernel,
                                   float(drop_rate), int(seed), int(row0))

    monkeypatch.setattr(FA, "flash_attention", flash)
    monkeypatch.setattr(SF, "swiglu_conv_deconv", core)
    return prims.calls


def _counts():
    fns = (U.flash_forward_fp32, U.flash_backward_fp32, U.ffn_core_fp32,
           U.ffn_core_fp32_backward, FA.flash_attention_backward, SF.swiglu_ffn_backward)
    return [f.launches for f in fns]


def test_use_amp_false_small_step_on_the_fp32_kernels_matches_jax(rng, emulated_card):
    """``use_amp: false`` (fp32 blocks) for one AdamW step of a model of the
    small config's structure (1 layer, dropout 0) through the fp32 kernels'
    chains and autograd Functions (#6 with its stash, #7, #8, #9: one
    counted launch a call, none on the bf16 kernels' counters) against
    ``make_train_step``: the loss terms and the pre-clip grad_norm within
    2e-4."""
    from mss_tf_locoformer_tpu.convert.torch_ckpt import convert_state_dict
    from mss_tf_locoformer_tpu.core import config as JC
    from mss_tf_locoformer_tpu.models.mss_tflocoformer import TFLocoformerMSS as JaxMSS
    from mss_tf_locoformer_tpu.train import state as JSt
    from mss_tf_locoformer_tpu.train.step import make_train_step
    from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
    from mss_tf_locoformer_tpu_torch.core.precision import FP32, precision_from_amp
    from mss_tf_locoformer_tpu_torch.models import build_model
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    from mss_tf_locoformer_tpu_torch.train.step import train_step
    raw = {"model": dict(SMALL, n_layers=1, n_fft=256, hop_length=64, fused_stft=True),
           "loss": {"loss_type": "si_sdr"},
           "training": dict(batch_size=2, gradient_clip=5.0, use_amp=False,
                            optimizer=dict(lr=1e-3, weight_decay=0.01))}
    cfg_t, cfg_j = C.config_from_dict(raw), JC.config_from_dict(raw)
    precision = precision_from_amp(cfg_t.training.use_amp, cfg_t.training.amp_dtype)
    assert precision == FP32
    jmodel = JaxMSS(cfg_j.model)
    mix = (0.3 * rng.standard_normal((2, 1200))).astype(np.float32)
    tgts = {s: (0.3 * rng.standard_normal((2, 1200))).astype(np.float32) for s in STEMS}
    params = jmodel.init(jax.random.PRNGKey(0), mix[:1])
    sd = jax_params_to_state_dict(jax.device_get(params))
    model = build_model(cfg_t.model, precision)
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(model.parameters(), cfg_t.training)
    tx = JSt.make_optimizer(cfg_j.training)
    state = JSt.init_state(convert_state_dict({k: v.numpy() for k, v in sd.items()}), tx)
    _, ld_j = make_train_step(jmodel, cfg_j, tx)(state, mix, tgts, 1e-3, jax.random.PRNGKey(1))
    before = _counts()
    ld_t = train_step(model, opt, _t(mix), {k: _t(v) for k, v in tgts.items()}, 1e-3,
                      torch.Generator().manual_seed(0), cfg_t.loss, accum=1,
                      gradient_clip=cfg_t.training.gradient_clip)
    # 1 layer x 2 paths: one attention core and one FFN core each
    assert [a - b for a, b in zip(_counts(), before)] == [2, 2, 2, 2, 0, 0]
    assert emulated_card["attn_bwd"] == 2 and emulated_card["qkv_split"] == 4
    for k in ("total_loss", "grad_norm"):
        np.testing.assert_allclose(float(ld_t[k]), float(ld_j[k]), rtol=2e-4, err_msg=k)


# ------------------------------------------------------------- dispatch

def test_fp32_cuda_dispatch_goes_to_the_fp32_kernels(monkeypatch):
    """The card branch sends fp32 tensors to ``unfused_fp32`` (checked
    without a card by a stub) and never to the bf16 kernels; fp16 tensors
    raise ``TypeError`` in the wrappers' checks."""
    seen = []
    stub = types.SimpleNamespace(
        flash_forward_fp32=lambda *a, **k: seen.append("fwd") or ("out", "lse"),
        flash_backward_fp32=lambda *a, **k: seen.append("bwd") or "grads",
        ffn_core_fp32=lambda *a, **k: seen.append("core") or "out",
        ffn_core_fp32_backward=lambda *a, **k: seen.append("core_bwd") or "grads",
        supports_flash=U.supports_flash, supports_core=U.supports_core)
    monkeypatch.setattr(FA, "unfused_fp32", stub)
    monkeypatch.setattr(SF, "unfused_fp32", stub)
    q = torch.zeros(1, 2, 8, 16)
    x = torch.zeros(1, 11, 48)
    w = [torch.zeros(s) for s in ((384, 48, 4), (384,), (192, 48, 4), (48,))]
    assert FA._forward(q, q, q, True, 10000.0, True) == ("out", "lse")
    assert FA.flash_attention_backward(q, q, q, q, q, q, True, 10000.0) == "grads"
    assert SF.core_forward(x, *w, 4) == "out"
    assert SF.swiglu_ffn_backward(x, x, *w[:3], 4) == "grads"
    assert seen == ["fwd", "bwd", "core", "core_bwd"]
    FA._check(q, q, q)
    SF._check(x, *w, 4)
    with pytest.raises(TypeError):
        FA._check(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        FA._check(q, q.double(), q)
    with pytest.raises(TypeError):
        SF._check(x.half(), *w, 4)
    # nor do the fused steps' gates take the small structure's fp32 rows
    assert FB.supports_step(48, 192, 4, False, 4, torch.float32) is False
