"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (``chip_smoke.py`` covers the main path's).

Needs a CUDA device and nvcc; skipped elsewhere.  On the GPU machine:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q
"""

import pytest
import torch

from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF

pytestmark = pytest.mark.cuda

# bf16 rows: kernel and plain version round at different places; about one
# bf16 step of the output apart (see chip_smoke.py's tolerance note)
STEP_TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the plain versions are the oracle: full fp32 in their convs and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, ref, tol_rel):
    ref = ref.float() if not ref.is_complex() else ref
    got = got.float() if not got.is_complex() else got
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= tol_rel * scale, (err, scale)


# (n_fft, hop, signals, samples): every frame count ragged against the
# kernels' 8 frames a block (87, 47, 20, 18, 30 frames)
FFT_SHAPES = [(2048, 512, 3, 44100), (256, 64, 3, 3000), (1024, 256, 3, 5000),
              (128, 64, 1, 1100), (4096, 1024, 2, 30000)]


@pytest.mark.parametrize("n_fft,hop,b,t", FFT_SHAPES)
def test_stft_kernel(dev, n_fft, hop, b, t):
    g = torch.Generator().manual_seed(0)
    audio = (0.1 * torch.randn(b, t, generator=g)).to(dev)
    got = SK.stft_fused(audio, n_fft, hop)
    torch.cuda.synchronize()
    _close(got, SK.reference_stft(audio, n_fft, hop), 1e-4)


def test_fft_kernels_refuse_other_sizes(dev):
    """n_fft outside the kernels' power-of-two range raises on the card: no
    fallback to the plain version."""
    for n_fft in (1000, 64, 8192):
        audio = torch.randn(1, 3 * n_fft, device=dev)
        spec = torch.zeros(1, n_fft // 2 + 1, 4, dtype=torch.complex64, device=dev)
        for call in (lambda: SK.stft_fused(audio, n_fft, n_fft // 4),
                     lambda: SK.windowed_frames(spec, n_fft),
                     lambda: SK.istft_fused(spec, n_fft, n_fft // 4),
                     lambda: SK.frames_to_audio(torch.zeros(1, 4, n_fft, device=dev),
                                                n_fft, n_fft // 4)):
            with pytest.raises(ValueError, match="power-of-two n_fft from 128 to 4096"):
                call()
    # a hop whose block's signal span exceeds the shared memory: refused by
    # the launch, with the size in the message
    with pytest.raises(RuntimeError, match="n_fft 4096, hop 8192"):
        SK.stft_fused(torch.randn(1, 3 * 4096, device=dev), 4096, 8192)


@pytest.mark.parametrize("r,seq,c,inner,k", [(1, 5, 96, 384, 4), (3, 61, 32, 64, 8),
                                             (2, 130, 64, 96, 3), (2, 200, 128, 64, 6),
                                             (2, 300, 96, 384, 4), (3, 62, 128, 384, 4),
                                             (2, 250, 96, 100, 8), (2, 130, 128, 192, 8)])
def test_ffn_step_kernel(dev, r, seq, c, inner, k):
    """C 32 and 64 on the wmma kernels; C 96 and 128 on the Hopper kernels,
    whose tiles run over the rows laid end to end: tiles across row ends
    (300), several short rows in a tile (5, 62), k 8 (121 outputs a tile)
    and inner widths padded to 64 (100)."""
    g = torch.Generator().manual_seed(1)
    b = (c * k) ** -0.5
    x = torch.randn(r, seq, c, generator=g).to(dev, torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
    w = [((torch.rand(*s, generator=g) * 2 - 1) * b).to(dev)
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    got = FB.fused_norm_ffn_residual(x, gamma, *w, k, 4, 1e-5)
    torch.cuda.synchronize()
    _close(got, FB.reference_norm_ffn_residual(x, gamma, *w, k, 4, 1e-5), STEP_TOL)


@pytest.mark.parametrize("r,seq,c,a,h,rope", [(1, 1, 96, 96, 4, True),
                                              (2, 37, 32, 32, 2, True),
                                              (2, 130, 96, 96, 4, True),
                                              (3, 64, 64, 96, 3, False)])
def test_attention_step_kernel(dev, r, seq, c, a, h, rope):
    g = torch.Generator().manual_seed(2)
    x = (0.5 * torch.randn(r, seq, c, generator=g)).to(dev, torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
    w_qkv = ((torch.rand(3 * a, c, generator=g) * 2 - 1) * 2 * c ** -0.5).to(dev)
    w_out = ((torch.rand(c, a, generator=g) * 2 - 1) * a ** -0.5).to(dev)
    got = AB.fused_attention_block(x, gamma, w_qkv, w_out, h, 4, 1e-5, rope)
    torch.cuda.synchronize()
    ref = AB.reference_attention_block(x, gamma, w_qkv, w_out, h, 4, 1e-5, rope)
    _close(got, ref, STEP_TOL)


# The iSTFT kernel (#10): fp32 on both sides, as the STFT's tolerance
ISTFT_TOL = 1e-4


@pytest.mark.parametrize("n_fft,hop,b,t", FFT_SHAPES)
def test_istft_kernel(dev, n_fft, hop, b, t):
    g = torch.Generator().manual_seed(5)
    spec = SK.reference_stft((0.1 * torch.randn(b, t, generator=g)).to(dev), n_fft, hop)
    # torch.stft's output is a transposed view; the kernel reads it as it lies
    for s in (spec, spec.contiguous()):
        got = SK.windowed_frames(s, n_fft)
        torch.cuda.synchronize()
        _close(got, SK.reference_windowed_frames(s, n_fft), ISTFT_TOL)
        _close(SK.istft_fused(s, n_fft, hop, t), SK.reference_istft(s, n_fft, hop, t),
               ISTFT_TOL)


@pytest.mark.parametrize("n_fft,hop,b,t", FFT_SHAPES)
def test_overlap_add_kernel(dev, n_fft, hop, b, t):
    """The overlap-add kernel against the plain fold, envelope and crop, at
    the signal's length and with no length; zero-padded past the end."""
    g = torch.Generator().manual_seed(7)
    spec = SK.reference_stft((0.1 * torch.randn(b, t, generator=g)).to(dev), n_fft, hop)
    frames = SK.reference_windowed_frames(spec, n_fft)
    for length in (t, None):
        got = SK.frames_to_audio(frames, n_fft, hop, length)
        torch.cuda.synchronize()
        _close(got, SK.reference_frames_to_audio(frames, n_fft, hop, length), ISTFT_TOL)
    short = SK.frames_to_audio(frames, n_fft, hop, None)
    long = SK.frames_to_audio(frames, n_fft, hop, short.shape[-1] + n_fft // 2 + 5)
    assert torch.equal(long[:, :short.shape[-1]], short)
    assert not long[:, -5:].any()


def test_istft_kernel_gradient(dev):
    """The Function's backward (the plain version's adjoint) against autograd
    through the plain version."""
    g = torch.Generator().manual_seed(6)
    spec = SK.reference_stft(torch.randn(2, 5000, generator=g).to(dev), 1024, 256)
    cot = torch.randn(2, 5000, generator=g).to(dev)
    grads = []
    for fn in (SK.istft_fused, SK.reference_istft):
        s = spec.detach().requires_grad_(True)
        (d,) = torch.autograd.grad(fn(s, 1024, 256, 5000), s, cot)
        grads.append(d)
    _close(*grads, ISTFT_TOL)


@pytest.mark.parametrize("r,seq", [(3, 62), (2, 130)])
def test_steps_at_bs_width(dev, r, seq):
    """The FFN step (C 128, I 384, k 4) and the attention step (4 heads of
    32, no head padding) at BS-Locoformer's widths, over 62 bands too."""
    g = torch.Generator().manual_seed(7)
    c = 128
    x = (0.5 * torch.randn(r, seq, c, generator=g)).to(dev, torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
    b = (c * 4) ** -0.5
    w = [((torch.rand(*s, generator=g) * 2 - 1) * b).to(dev)
         for s in ((768, c, 4), (768,), (384, c, 4), (c,))]
    got = FB.fused_norm_ffn_residual(x, gamma, *w, 4, 4, 1e-5)
    torch.cuda.synchronize()
    _close(got, FB.reference_norm_ffn_residual(x, gamma, *w, 4, 4, 1e-5), STEP_TOL)
    w_qkv = ((torch.rand(3 * c, c, generator=g) * 2 - 1) * 2 * c ** -0.5).to(dev)
    w_out = ((torch.rand(c, c, generator=g) * 2 - 1) * c ** -0.5).to(dev)
    got = AB.fused_attention_block(x, gamma, w_qkv, w_out, 4, 4, 1e-5)
    torch.cuda.synchronize()
    _close(got, AB.reference_attention_block(x, gamma, w_qkv, w_out, 4, 4, 1e-5), STEP_TOL)


def test_ffn_step_too_large_for_shared_memory_raises(dev):
    """Every routed shape fits a block's shared memory now (C 128 with k 8,
    the speech configs', takes the Hopper kernels), so the launch refuses
    what the layouts do not take -- 9 taps, a halo past the tile's 8 spare
    rows -- and the wrapper raises."""
    x = torch.zeros(1, 16, 128, device=dev, dtype=torch.bfloat16)
    w = [torch.zeros(*s, device=dev) for s in ((128, 128, 9), (128,), (64, 128, 9), (128,))]
    with pytest.raises(RuntimeError, match="cudaError"):
        FB.ffn_step_forward(x, torch.ones(128, device=dev), *w, 9, 4, 1e-5)


def test_kernels_refuse_fp16_rows(dev):
    """bf16 rows take the step kernels, fp32 rows the fp32 ones; fp16 rows
    neither (no cast)."""
    x = torch.randn(2, 16, 32, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        FB.fused_norm_ffn_residual(x, x[0, 0], *(torch.zeros(1, device=dev),) * 4, 4, 4, 1e-5)
    with pytest.raises(TypeError):
        AB.fused_attention_block(x, x[0, 0], x, x, 2, 4, 1e-5)


# fp32 rows (csrc/step_fp32.cu): fp32 operands and sums on both sides, so
# outputs within FP32_TOL of max|ref| and gradients within FP32_REL_L2 (the
# sums' order differs: ~1e-6 relative)
FP32_TOL, FP32_REL_L2 = 1e-4, 1e-4


def _check_fp32(out, ref_out, got, ref, names, tol=FP32_TOL, rel=FP32_REL_L2):
    _close(out, ref_out, tol)
    for name, a, b in zip(names, got, ref):
        assert torch.isfinite(a).all(), name
        if b.abs().max().item() == 0:
            assert not a.any(), name
        elif name == "dx":
            _close(a, b, tol)
        else:
            assert _rel_l2(a, b) <= rel, (name, _rel_l2(a, b))


@pytest.mark.parametrize("drop,residual", [(0.0, True), (0.1, True), (0.1, False)])
@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 1, 96, 384, 4), (3, 65, 128, 384, 4),
                                             (2, 130, 64, 96, 3), (3, 61, 128, 192, 8),
                                             (2, 37, 32, 64, 4)])
def test_fp32_ffn_step_kernels(dev, r, seq, c, inner, k, drop, residual):
    """#2 and #5 on fp32 rows against autograd through the plain version in
    fp32, both dropout sites, the partial-sum mode; one counted launch each
    way and none on the bf16 kernels."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    x, params, g = _ffn_inputs(dev, r, seq, c, inner, k)
    x, g = x.float(), g.float()
    if not residual:
        params = params[:4] + [None]
    args = (k, 4, 1e-5, drop, 1234, 7, residual)
    grad_params = [p for p in params if p is not None]
    fn = lambda kern: lambda x_, *p: kern(x_, *p, *([None] if not residual else []), *args)
    counts = (S.ffn_forward.launches, S.ffn_backward.launches, FB.fused_norm_ffn_residual.launches)
    out, got = _grads(fn(FB.fused_norm_ffn_residual), x, grad_params, g)
    torch.cuda.synchronize()
    assert (S.ffn_forward.launches, S.ffn_backward.launches,
            FB.fused_norm_ffn_residual.launches) == (counts[0] + 1, counts[1] + 1, counts[2])
    ref_out, ref = _grads(fn(FB.reference_norm_ffn_residual), x, grad_params, g)
    _check_fp32(out, ref_out, got, ref,
                ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b"))


@pytest.mark.parametrize("drop,residual", [(0.0, True), (0.1, True), (0.1, False)])
@pytest.mark.parametrize("r,seq,c,a,h,rope", [(1, 1, 96, 96, 4, True), (2, 65, 128, 128, 4, True),
                                              (2, 130, 96, 96, 4, True),
                                              (3, 70, 64, 48, 2, False)])
def test_fp32_attention_step_kernels(dev, r, seq, c, a, h, rope, drop, residual):
    """#3 and #4 on fp32 rows against autograd through the plain version in
    fp32: both dropout sites, RoPE on and off, the partial-sum mode."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    x, params, g = _attn_inputs(dev, r, seq, c, a)
    x, g = x.float(), g.float()
    args = (h, 4, 1e-5, rope, 10000.0, drop, 4321, 5, residual)
    counts = (S.attention_forward.launches, S.attention_backward.launches)
    out, got = _grads(lambda *p: AB.fused_attention_block(*p, *args), x, params, g)
    torch.cuda.synchronize()
    assert (S.attention_forward.launches, S.attention_backward.launches) == \
        (counts[0] + 1, counts[1] + 1)
    ref_out, ref = _grads(lambda *p: AB.reference_attention_block(*p, *args), x, params, g)
    _check_fp32(out, ref_out, got, ref, ("dx", "dgamma", "dw_qkv", "dw_out"))


def test_fp32_steps_give_the_same_bits_twice(dev):
    """No atomics in the fp32 chains: two runs of #5 (in 3 row groups) and
    of #4 at dropout 0.1 are bit-equal."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    r, seq, c, inner, k = 5, 120, 128, 192, 4
    x, params, g = _ffn_inputs(dev, r, seq, c, inner, k)
    x, g = x.float(), g.float()
    cap = 2 * 4 * (3 * seq * c + 5 * (seq + k - 1) * inner)
    assert S.ffn_rows(r, seq, c, inner, k, True, cap) == 2
    args = (g, x, *params[:4], k, 4, 1e-5, 0.1, 1234, 7)
    first = FB.ffn_step_backward(*args, scratch_cap=cap)
    again = FB.ffn_step_backward(*args, scratch_cap=cap)
    whole = FB.ffn_step_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(_rel_l2(a, b) < 1e-5 for a, b in zip(first[1:], whole[1:]))
    x, (gamma, w_qkv, w_out), g = _attn_inputs(dev, 3, 300, 96, 96)
    x, g = x.float(), g.float()
    args = (4, 4, 1e-5, True, 10000.0, 0.1, 5, 0)
    _, stash = AB.attention_step_forward(x, gamma, w_qkv, w_out, *args, stash=True)
    first = AB.attention_step_backward(g, x, gamma, w_qkv, w_out, stash, *args)
    again = AB.attention_step_backward(g, x, gamma, w_qkv, w_out, stash, *args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_fp32_speech_separator_on_the_card(dev):
    """An fp32 separator on the card runs its fused steps on the fp32
    kernels: its output against the same weights on the plain route (the
    speech CLIs' default precision since the fp32 kernels)."""
    import dataclasses
    from mss_tf_locoformer_tpu_torch.core.config import SeparatorConfig
    from mss_tf_locoformer_tpu_torch.models import TFLocoformerSeparator
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    cfg = SeparatorConfig(n_layers=2, flash_attention=True, fused_ffn=True,
                          ffn_type=("swiglu_conv1d", "swiglu_conv1d"), ffn_hidden_dim=(384, 384))
    sep = TFLocoformerSeparator(cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    plain = TFLocoformerSeparator(dataclasses.replace(cfg, flash_attention=False,
                                                      fused_ffn=False)).to(dev).eval()
    plain.load_state_dict(sep.state_dict(), strict=True)
    spec = torch.randn(1, 50, 65, dtype=torch.complex64,
                       generator=torch.Generator().manual_seed(1)).to(dev)
    before = S.ffn_forward.launches, S.attention_forward.launches
    with torch.no_grad():
        got, ref = sep(spec), plain(spec)
    torch.cuda.synchronize()
    assert (S.ffn_forward.launches - before[0], S.attention_forward.launches - before[1]) == (8, 4)
    _close(torch.view_as_real(got), torch.view_as_real(ref), FP32_TOL)


def test_launch_counters_count_launches(dev):
    before = SK.stft_fused.launches
    spec = SK.stft_fused(torch.randn(1, 4096, device=dev), 1024, 256)
    assert SK.stft_fused.launches == before + 1
    before = SK.istft_fused.launches, SK.frames_to_audio.launches
    SK.istft_fused(spec, 1024, 256)
    assert (SK.istft_fused.launches, SK.frames_to_audio.launches) == \
        (before[0] + 1, before[1] + 1)


# Backward and dropout.  The kernels run on bf16 rows; their plain versions
# run autograd in fp32 on the same (bf16-valued) inputs.  The kernels round
# xn, the SwiGLU output, dy, P and dS to bf16 on the way (as the TPU kernels
# do), about 2^-9 relative per element; dx is held to STEP_TOL x max|ref|,
# the weight and gamma gradients (sums over every position) to a relative
# L2 error of GRAD_REL_L2.
GRAD_REL_L2 = 2e-2


def _rel_l2(got, ref):
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm()).item()


def _grads(fn, x, params, g):
    x = x.detach().requires_grad_(True)
    ps = [p.detach().requires_grad_(True) for p in params]
    out = fn(x, *ps)
    grads = torch.autograd.grad(out, [x, *ps], g)
    return out, grads


def _check_grads(got, ref, names):
    for name, a, b in zip(names, got, ref):
        assert b.abs().max().item() > 0, name
        assert torch.isfinite(a).all(), name
        if name == "dx":
            _close(a, b, STEP_TOL)
        else:
            assert _rel_l2(a, b) <= GRAD_REL_L2, (name, _rel_l2(a, b))


def _ffn_inputs(dev, r, seq, c, inner, k, seed=3):
    gen = torch.Generator().manual_seed(seed)
    b = (c * k) ** -0.5
    x = torch.randn(r, seq, c, generator=gen).to(dev, torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(c, generator=gen)).to(dev)
    w = [((torch.rand(*s, generator=gen) * 2 - 1) * b).to(dev)
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    g = torch.randn(r, seq, c, generator=gen).to(dev, torch.bfloat16)
    return x, [gamma, *w], g


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 1, 96, 384, 4), (3, 37, 32, 64, 4),
                                             (2, 130, 64, 96, 3), (2, 130, 96, 384, 4),
                                             (3, 62, 128, 384, 4), (2, 300, 128, 192, 8),
                                             (2, 250, 96, 100, 8)])
def test_ffn_step_backward_kernel(dev, r, seq, c, inner, k, drop):
    x, params, g = _ffn_inputs(dev, r, seq, c, inner, k)
    args = (k, 4, 1e-5, drop, 1234, 7)
    out, got = _grads(lambda *a: FB.fused_norm_ffn_residual(*a, *args), x, params, g)
    ref_out, ref = _grads(lambda *a: FB.reference_norm_ffn_residual(*a, *args),
                          x.float(), params, g.float())
    torch.cuda.synchronize()
    _close(out, ref_out, STEP_TOL)
    _check_grads(got, ref, ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b"))


@pytest.mark.parametrize("c", [96, 128])
def test_ffn_step_backward_is_deterministic(dev, c):
    """Two #5 runs on the same inputs give the same bits (no atomics: every
    partial is summed in a fixed order), here across 3 row groups."""
    r, seq, inner, k = 5, 300, 192, 4
    x, params, g = _ffn_inputs(dev, r, seq, c, inner, k)
    cap = 2 * FB.wg_step_plan(1, seq, c, inner, k)["scratch_bytes"]
    args = (g, x, *params[:4], k, 4, 1e-5, 0.1, 1234, 7)
    first = FB.ffn_step_backward(*args, scratch_cap=cap)
    again = FB.ffn_step_backward(*args, scratch_cap=cap)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("c", [96, 128])
def test_ffn_step_backward_row_groups(dev, c):
    """A scratch cap of two rows splits 5 rows into 3 groups (the last one
    short): the gradients match autograd through the plain version, dx is
    bit-equal to the one-group run's and the weight gradients differ from
    it only by the order of their fp32 sums."""
    r, seq, inner, k = 5, 200, 128, 4
    x, params, g = _ffn_inputs(dev, r, seq, c, inner, k)
    cap = 2 * FB.wg_step_plan(1, seq, c, inner, k)["scratch_bytes"]
    assert FB.wg_step_plan(r, seq, c, inner, k, cap)["groups"] == 3
    args = (g, x, *params[:4], k, 4, 1e-5, 0.1, 1234, 7)
    got = FB.ffn_step_backward(*args, scratch_cap=cap)
    whole = FB.ffn_step_backward(*args)
    torch.cuda.synchronize()
    _, ref = _grads(lambda *a: FB.reference_norm_ffn_residual(*a, k, 4, 1e-5, 0.1, 1234, 7),
                    x.float(), params, g.float())
    _check_grads(got, ref, ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b"))
    assert torch.equal(got[0], whole[0])
    for a, b in zip(got[1:], whole[1:]):
        assert _rel_l2(a, b) < 1e-5


def _attn_inputs(dev, r, seq, c, a, seed=4):
    gen = torch.Generator().manual_seed(seed)
    x = (0.5 * torch.randn(r, seq, c, generator=gen)).to(dev, torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(c, generator=gen)).to(dev)
    w_qkv = ((torch.rand(3 * a, c, generator=gen) * 2 - 1) * 2 * c ** -0.5).to(dev)
    w_out = ((torch.rand(c, a, generator=gen) * 2 - 1) * a ** -0.5).to(dev)
    g = torch.randn(r, seq, c, generator=gen).to(dev, torch.bfloat16)
    return x, [gamma, w_qkv, w_out], g


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("r,seq,c,a,h,rope", [(1, 1, 96, 96, 4, True),
                                              (2, 37, 32, 32, 2, True),
                                              (2, 130, 96, 96, 4, True),
                                              (3, 130, 64, 96, 3, False)])
def test_attention_step_backward_kernel(dev, r, seq, c, a, h, rope, drop):
    x, params, g = _attn_inputs(dev, r, seq, c, a)
    args = (h, 4, 1e-5, rope, 10000.0, drop, 4321, 5)
    out, got = _grads(lambda *p: AB.fused_attention_block(*p, *args), x, params, g)
    ref_out, ref = _grads(lambda *p: AB.reference_attention_block(*p, *args),
                          x.float(), params, g.float())
    torch.cuda.synchronize()
    _close(out, ref_out, STEP_TOL)
    _check_grads(got, ref, ("dx", "dgamma", "dw_qkv", "dw_out"))


# The speech configs' step shapes: short frequency axes (L 65 at n_fft 128,
# 129 at 256), C 128 with 4 heads of 32, I 384 at k 4 and I 192 at k 8
# (WHAMR: a lead pad of 7); RoPE off at k 8, as WHAMR's NoPE variant
SPEECH_SHAPES = [(3, 65, 384, 4, True), (2, 129, 384, 4, True), (3, 65, 192, 8, False),
                 (2, 129, 192, 8, True)]


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("r,seq,inner,k,rope", SPEECH_SHAPES)
def test_steps_at_speech_shapes(dev, r, seq, inner, k, rope, drop):
    """#2 and #5, #3 and #4 forward and backward against autograd through
    their plain versions at the speech shapes."""
    x, params, g = _ffn_inputs(dev, r, seq, 128, inner, k)
    args = (k, 4, 1e-5, drop, 1234, 7)
    out, got = _grads(lambda *a: FB.fused_norm_ffn_residual(*a, *args), x, params, g)
    ref_out, ref = _grads(lambda *a: FB.reference_norm_ffn_residual(*a, *args),
                          x.float(), params, g.float())
    torch.cuda.synchronize()
    _close(out, ref_out, STEP_TOL)
    _check_grads(got, ref, ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b"))
    x, params, g = _attn_inputs(dev, r, seq, 128, 128)
    args = (4, 4, 1e-5, rope, 10000.0, drop, 4321, 5)
    out, got = _grads(lambda *p: AB.fused_attention_block(*p, *args), x, params, g)
    ref_out, ref = _grads(lambda *p: AB.reference_attention_block(*p, *args),
                          x.float(), params, g.float())
    torch.cuda.synchronize()
    _close(out, ref_out, STEP_TOL)
    _check_grads(got, ref, ("dx", "dgamma", "dw_qkv", "dw_out"))


# The two cores of #3 (and #4's passes over them): resident k and v at L
# <= 1808, the streaming core beyond; ragged tails on both
@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("r,seq,c,a,h,resident", [(2, 70, 64, 64, 2, True),
                                                  (1, 1850, 32, 32, 2, False)])
def test_attention_step_core_routes(dev, r, seq, c, a, h, resident, drop):
    assert AB.core_resident(seq) == resident
    x, params, g = _attn_inputs(dev, r, seq, c, a, seed=11)
    args = (h, 4, 1e-5, True, 10000.0, drop, 99, 2)
    out, got = _grads(lambda *p: AB.fused_attention_block(*p, *args), x, params, g)
    ref_out, ref = _grads(lambda *p: AB.reference_attention_block(*p, *args),
                          x.float(), params, g.float())
    torch.cuda.synchronize()
    _close(out, ref_out, STEP_TOL)
    _check_grads(got, ref, ("dx", "dgamma", "dw_qkv", "dw_out"))


def test_attention_step_backward_gives_the_same_bits_twice(dev):
    """No atomics: two runs of #4 at dropout 0.1 are bit-equal."""
    x, (gamma, w_qkv, w_out), g = _attn_inputs(dev, 3, 300, 96, 96)
    args = (4, 4, 1e-5, True, 10000.0, 0.1, 5, 0)
    _, stash = AB.attention_step_forward(x, gamma, w_qkv, w_out, *args, stash=True)
    first = AB.attention_step_backward(g, x, gamma, w_qkv, w_out, stash, *args)
    again = AB.attention_step_backward(g, x, gamma, w_qkv, w_out, stash, *args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_dropout_masks_change_with_the_seed_and_replay(dev):
    """Two seeds give two outputs; one seed gives the same output twice."""
    x, params, _ = _ffn_inputs(dev, 2, 50, 64, 64, 4)
    f = lambda s: FB.fused_norm_ffn_residual(x, *params, 4, 4, 1e-5, 0.1, s)
    assert torch.equal(f(1), f(1))
    assert not torch.equal(f(1), f(2))
    xa, pa, _ = _attn_inputs(dev, 2, 50, 64, 64)
    fa = lambda s: AB.fused_attention_block(xa, *pa, 4, 4, 1e-5, True, 10000.0, 0.1, s)
    assert torch.equal(fa(1), fa(1))
    assert not torch.equal(fa(1), fa(2))


def test_stft_kernel_passes_gradients(dev):
    audio = torch.randn(2, 5000, device=dev, requires_grad=True)
    spec = SK.stft_fused(audio, 1024, 256)
    (ga,) = torch.autograd.grad(spec.abs().sum(), audio)
    ref = audio.detach().requires_grad_(True)
    (gr,) = torch.autograd.grad(SK.reference_stft(ref, 1024, 256).abs().sum(), ref)
    assert _rel_l2(ga, gr) < 1e-3


# The unfused route's kernels: flash attention (#6) and the FFN core (#8),
# bf16 against their plain versions in bf16 (one bf16 step apart, STEP_TOL).

# Besides small and ragged shapes: the 129- and 513-position tails (one live
# query and key in the last 16-row tile), D 12 through the small config's
# 288-byte position stride (4 heads of 12), L 1300 (one resident block an
# SM), and shapes beyond the resident forward's gate (L 2500 at D 16, L 1000
# at D 64: the streaming kernel).
FLASH_SHAPES = [(2, 3, 65, 12, True), (1, 16, 130, 16, True), (2, 2, 37, 24, False),
                (3, 4, 1, 16, True), (1, 2, 200, 64, True), (1, 16, 129, 16, True),
                (2, 4, 513, 12, True), (1, 4, 129, 12, False), (1, 1, 2500, 16, True),
                (1, 2, 1000, 64, True), (1, 2, 1300, 16, True)]


@pytest.mark.parametrize("r,h,seq,d,rope", FLASH_SHAPES)
def test_flash_attention_kernel(dev, r, h, seq, d, rope):
    g = torch.Generator().manual_seed(5)
    qkv = (1.5 * torch.randn(r, seq, 3, h, d, generator=g)).to(dev, torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)        # the MHSA's strided views
    got = FA.flash_attention(q, k, v, rope)
    torch.cuda.synchronize()
    assert got.shape == (r, h, seq, d)
    _close(got, FA.reference_flash_attention(q, k, v, rope), STEP_TOL)
    dense = FA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), rope)
    assert torch.equal(got, dense)
    flat = FA.flash_attention(q[0], k[0], v[0], rope)          # [H, L, D]: 3-D input
    assert torch.equal(flat, got[0])


def _core_inputs(dev, r, seq, c, inner, k, seed=6):
    gen = torch.Generator().manual_seed(seed)
    x = torch.zeros(r, seq + 2 * (k - 1), c)
    x[:, k - 1:k - 1 + seq] = torch.randn(r, seq, c, generator=gen)
    b = (c * k) ** -0.5
    w = [((torch.rand(*s, generator=gen) * 2 - 1) * b).to(dev)
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    return x.to(dev, torch.bfloat16), w


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 37, 48, 64, 4), (2, 130, 256, 96, 4),
                                             (3, 5, 16, 32, 8), (1, 61, 256, 1024, 4),
                                             (2, 70, 96, 192, 3), (1, 9, 112, 40, 2),
                                             (2, 300, 128, 160, 3), (1, 4, 256, 64, 8)])
def test_swiglu_ffn_kernel(dev, r, seq, c, inner, k, drop):
    x, w = _core_inputs(dev, r, seq, c, inner, k)
    got = SF.swiglu_conv_deconv(x, *w, k, drop, 1234, 7)
    torch.cuda.synchronize()
    _close(got, SF.reference_swiglu_conv_deconv(x, *w, k, drop, 1234, 7), STEP_TOL)


def _all_grads(fn, inputs, g):
    """``(out, grads of every input)`` of ``fn(*inputs)`` for the cotangent ``g``."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, g)


def _grad_close(got, ref):
    """bf16 kernel gradients against fp32 autograd through the plain
    version: the first (the rows) within STEP_TOL x max|ref|, the weight
    gradients (sums over every position) by relative L2 within 2e-2."""
    _close(got[0], ref[0], STEP_TOL)
    for a, b in zip(got[1:], ref[1:]):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, b) < 2e-2


# The forward's shapes but the largest (its plain fp32 scores' autograd), and
# L 600 at D 16, beyond the resident backward's gate (the streaming kernels).
FLASH_BWD_SHAPES = FLASH_SHAPES[:8] + [(1, 2, 600, 16, True), (1, 2, 1000, 64, True)]


@pytest.mark.parametrize("r,h,seq,d,rope", FLASH_BWD_SHAPES)
def test_flash_attention_backward_kernel(dev, r, h, seq, d, rope):
    """#7 through the autograd Function on the MHSA's strided views against
    autograd through the plain version in fp32; without a gradient no stash
    and no backward launch."""
    g = torch.Generator().manual_seed(7)
    qkv = (1.5 * torch.randn(r, seq, 3, h, d, generator=g)).to(dev, torch.bfloat16)
    go = torch.randn(r, h, seq, d, generator=g).to(dev, torch.bfloat16)
    leaf = qkv.detach().requires_grad_(True)
    q, k, v = leaf.permute(2, 0, 3, 1, 4)
    n = FA.flash_attention_backward.launches
    out = FA.flash_attention(q, k, v, rope)
    (got,) = torch.autograd.grad(out, leaf, go)
    torch.cuda.synchronize()
    assert FA.flash_attention_backward.launches == n + 1
    ref_leaf = qkv.float().requires_grad_(True)
    rq, rk, rv = ref_leaf.permute(2, 0, 3, 1, 4)
    ref_out = FA.reference_flash_attention(rq, rk, rv, rope)
    (ref,) = torch.autograd.grad(ref_out, ref_leaf, go.float())
    _close(out, ref_out, STEP_TOL)
    for i in range(3):     # dq, dk, dv, each against its own scale
        if seq == 1 and i < 2:   # softmax over one key: no gradient reaches q or k
            assert got[:, :, i].abs().max() < 1e-5
        else:
            _close(got[:, :, i], ref[:, :, i], STEP_TOL)
    with torch.no_grad():
        FA.flash_attention(q, k, v, rope)
    assert FA.flash_attention_backward.launches == n + 1


@pytest.mark.parametrize("r,h,seq,d", [(2, 4, 513, 12), (1, 2, 600, 16)])
def test_flash_attention_backward_is_deterministic(dev, r, h, seq, d):
    """Two #7 runs on the same inputs give the same bits (no atomics), on
    the resident kernel and on the streaming ones."""
    assert FA.backward_resident(seq, d) == (seq == 513)
    g = torch.Generator().manual_seed(8)
    qkv = (1.5 * torch.randn(r, seq, 3, h, d, generator=g)).to(dev, torch.bfloat16)
    go = torch.randn(r, seq, h, d, generator=g).to(dev, torch.bfloat16)
    q4, k4, v4 = qkv.permute(2, 0, 3, 1, 4)
    out, lse = FA._forward(q4, k4, v4, True, 10000.0, True)
    first = FA.flash_attention_backward(go, q4, k4, v4, out, lse, True, 10000.0)
    again = FA.flash_attention_backward(go, q4, k4, v4, out, lse, True, 10000.0)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 37, 48, 192, 4), (2, 130, 256, 96, 4),
                                             (3, 5, 16, 32, 8), (1, 61, 256, 1024, 4),
                                             (2, 70, 96, 200, 3), (1, 9, 112, 36, 2),
                                             (2, 300, 128, 160, 3), (1, 4, 256, 64, 8)])
def test_swiglu_ffn_backward_kernel(dev, r, seq, c, inner, k, drop):
    """#9 through the autograd Function against autograd through the plain
    version in fp32, the inner mask replayed (rows offset by 7)."""
    x, w = _core_inputs(dev, r, seq, c, inner, k)
    gen = torch.Generator().manual_seed(8)
    go = torch.randn(*x.shape, generator=gen).to(dev, torch.bfloat16)
    n = SF.swiglu_ffn_backward.launches
    out, got = _all_grads(lambda *a: SF.swiglu_conv_deconv(*a, k, drop, 1234, 7), [x, *w], go)
    torch.cuda.synchronize()
    assert SF.swiglu_ffn_backward.launches == n + 1
    ref_out, ref = _all_grads(lambda *a: SF.reference_swiglu_conv_deconv(*a, k, drop, 1234, 7),
                          [x.float(), *w], go.float())
    _close(out, ref_out, STEP_TOL)
    _grad_close(got, ref)


@pytest.mark.parametrize("c", [128, 256])
def test_swiglu_ffn_backward_is_deterministic(dev, c):
    """Two #9 runs on the same inputs give the same bits (no atomics: the
    weight gradients' split partials are summed in a fixed order)."""
    r, seq, inner, k = 3, 300, 192, 4
    x, w = _core_inputs(dev, r, seq, c, inner, k)
    go = torch.randn(*x.shape, generator=torch.Generator().manual_seed(9)).to(dev, torch.bfloat16)
    first = SF.swiglu_ffn_backward(go, x, *w[:3], k, 0.1, 1234, 7)
    again = SF.swiglu_ffn_backward(go, x, *w[:3], k, 0.1, 1234, 7)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_swiglu_ffn_backward_row_groups(dev):
    """A scratch cap of two rows' dyvg and h splits 5 rows into 3 groups
    (the last one short): the gradients match autograd through the plain
    version, dx is bit-equal to the one-group run's and the weight
    gradients differ from it only by the order of their fp32 sums."""
    r, seq, c, inner, k = 5, 200, 256, 128, 4
    x, w = _core_inputs(dev, r, seq, c, inner, k)
    go = torch.randn(*x.shape, generator=torch.Generator().manual_seed(10)).to(
        dev, torch.bfloat16)
    lin = x.shape[1]
    cap = 2 * lin * 3 * inner * 2
    assert SF.wg_backward_plan(r, lin, c, inner, k, cap)["groups"] == 3
    got = SF.swiglu_ffn_backward(go, x, *w[:3], k, 0.1, 1234, 7, scratch_cap=cap)
    whole = SF.swiglu_ffn_backward(go, x, *w[:3], k, 0.1, 1234, 7)
    torch.cuda.synchronize()
    _, ref = _all_grads(lambda *a: SF.reference_swiglu_conv_deconv(*a, k, 0.1, 1234, 7),
                        [x.float(), *w], go.float())
    _grad_close(got, ref)
    assert torch.equal(got[0], whole[0])
    for a, b in zip(got[1:], whole[1:]):
        assert _rel_l2(a, b) < 1e-5


@pytest.mark.parametrize("shape_kind", ["rows", "inner", "group", "probability"])
def test_dropout_mask_kernel(dev, shape_kind):
    """The mask kernel gives the plain version's bits for every index
    layout the port uses."""
    from mss_tf_locoformer_tpu_torch.ops import dropout as D
    from mss_tf_locoformer_tpu_torch.ops.attention import group_keep_mask
    a = lambda n: torch.arange(n, device=dev)
    if shape_kind == "rows":        # [R, L, C], rows offset
        args = (7, D.SITE_FFN_OUTER, (a(5) + 3)[:, None, None], a(33)[None, :, None],
                a(50)[None, None])
    elif shape_kind == "inner":     # [R, I, Lc]: b (the channel) not last
        args = (7, D.SITE_FFN_INNER, a(3)[:, None, None], a(41)[None, None], a(36)[None, :, None])
    elif shape_kind == "group":     # [G, L, L], rows gathered
        rows = torch.tensor([4, 0, 9], device=dev)
        f = torch.arange(1, 6, device=dev)
        args = (9, D.SITE_ATTN_PROB, rows[f // 2][:, None, None], (f % 2)[:, None, None],
                a(37)[None, None], a(37)[None, :, None])
        assert torch.equal(group_keep_mask(9, rows, 2, 37, 1, 6, 0.2),
                           D.reference_keep_mask(*args, p=0.2))
    else:                           # [R, H, L, L], one row
        args = (2, D.SITE_ATTN_PROB, torch.tensor([6], device=dev).reshape(-1, 1, 1, 1),
                a(3)[None, :, None, None], a(19)[None, None, None], a(19)[None, None, :, None])
    n = D.keep_mask.launches
    got = D.keep_mask(*args, p=0.2)
    assert D.keep_mask.launches == n + 1
    assert torch.equal(got, D.reference_keep_mask(*args, p=0.2))


def test_gate_bytes_match_the_compiled_layouts(dev):
    for c, a, h in ((32, 32, 2), (96, 96, 4), (128, 128, 8), (256, 256, 16)):
        for training in (False, True):
            assert AB.compiled_launch_bytes(c, a, h, training) == \
                AB.launch_bytes(c, a, h, training)
    for seq in (1, 62, 259, 690, 1025, 1808, 1809, 2049):
        assert AB.compiled_core_resident_bytes(seq) == AB.core_resident_bytes(seq)
    for c in (32, 64, 96, 128):
        for k in (2, 3, 4, 8):
            for training in (False, True):
                assert FB.compiled_step_bytes(c, k, training) == FB.step_bytes(c, k, training)
    for c in FB.WG_WIDTHS:   # the Hopper layouts: forward, and the largest in training
        b = FB.wg_step_bytes(c)
        assert FB.compiled_step_bytes(c, 4, False) == b["fwd"]
        assert FB.compiled_step_bytes(c, 4, True) == max(b.values())
    for c in range(16, 257, 16):
        assert SF.compiled_core_bytes(c) == SF.core_bytes(c)
        for k in (2, 4, 8):
            assert SF.compiled_backward_bytes(c, k) == SF.backward_bytes(c, k)
    for seq in (1, 17, 129, 345, 513, 528, 529, 600, 1000, 2049, 2500):
        for d in (12, 16, 24, 32, 48, 64):
            assert FA.compiled_resident_bytes(seq, d) == (
                FA.forward_resident_bytes(seq, d), FA.backward_resident_bytes(seq, d))


# --------------------------------------------- partial-sum mode (#2-#5, TP)

@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("r,seq,c,inner,k", [(3, 37, 32, 32, 4), (2, 130, 64, 64, 3),
                                             (2, 130, 96, 192, 4), (2, 130, 96, 96, 4),
                                             (3, 62, 128, 192, 4), (2, 100, 128, 96, 8)])
def test_ffn_step_partial_sum_mode(dev, r, seq, c, inner, k, drop):
    """#2 and #5 with ``residual=False`` (the deconv output alone: no outer
    mask, no residual, no bias) against the plain version's partial-sum
    mode, forward and gradients (the inner mask replayed)."""
    x, params, g = _ffn_inputs(dev, r, seq, c, inner, k)
    params = params[:4]   # no deconv bias
    args = (None, k, 4, 1e-5, drop, 1234, 7, False)
    out, got = _grads(lambda *a: FB.fused_norm_ffn_residual(*a, *args), x, params, g)
    ref_out, ref = _grads(lambda *a: FB.reference_norm_ffn_residual(*a, *args),
                          x.float(), params, g.float())
    torch.cuda.synchronize()
    _close(out, ref_out, STEP_TOL)
    _check_grads(got, ref, ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w"))


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("r,seq,c,a,h,rope", [(2, 37, 32, 16, 1, True), (2, 130, 96, 48, 2, True),
                                              (2, 130, 96, 24, 1, True), (3, 70, 128, 64, 2, False)])
def test_attention_step_partial_sum_mode(dev, r, seq, c, a, h, rope, drop):
    """#3 and #4 with ``residual=False`` (the out-projection alone: no
    post-projection mask, no residual; the probability mask stays) against
    the plain version's partial-sum mode, at the shards' widths (one head
    of 24 at C 96: an attention width of 24, not a multiple of 16)."""
    x, params, g = _attn_inputs(dev, r, seq, c, a)
    args = (h, 4, 1e-5, rope, 10000.0, drop, 4321, 5, False)
    out, got = _grads(lambda *p: AB.fused_attention_block(*p, *args), x, params, g)
    ref_out, ref = _grads(lambda *p: AB.reference_attention_block(*p, *args),
                          x.float(), params, g.float())
    torch.cuda.synchronize()
    _close(out, ref_out, STEP_TOL)
    _check_grads(got, ref, ("dx", "dgamma", "dw_qkv", "dw_out"))


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_steps_summed_over_shards(dev, mp):
    """Each shard's partial-sum kernels (``parallel/sharding.py``'s head-
    and inner-major shards), summed in one process with the bias and the
    residual added outside, against the whole step's kernels at dropout 0:
    outputs, dx and the gathered weight gradients."""
    from mss_tf_locoformer_tpu_torch.parallel.sharding import shard_tensor, unshard_tensor
    r, seq, c, a, h, inner, k = 2, 130, 96, 96, 4, 384, 4
    fkeys = ("ffn.0.conv1d.weight", "ffn.0.conv1d.bias", "ffn.0.deconv1d.weight")
    akeys = ("attn.qkv.weight", "attn.aggregate_heads.0.weight")
    for name in ("ffn", "attention"):
        if name == "ffn":
            x, params, g = _ffn_inputs(dev, r, seq, c, inner, k)
            gamma, whole, bias = params[0], params[1:4], params[4]
            keys = fkeys
            full = lambda x, gm, *w: FB.fused_norm_ffn_residual(x, gm, *w, bias, k, 4, 1e-5)
            part = lambda x, gm, *w: FB.fused_norm_ffn_residual(x, gm, *w, None, k, 4, 1e-5,
                                                                residual=False)
        else:
            x, params, g = _attn_inputs(dev, r, seq, c, a)
            gamma, whole, bias = params[0], params[1:], torch.zeros(c, device=dev)
            keys = akeys
            full = lambda x, gm, *w: AB.fused_attention_block(x, gm, *w, h, 4, 1e-5)
            part = lambda x, gm, *w: AB.fused_attention_block(x, gm, *w, h // mp, 4, 1e-5,
                                                              residual=False)
        out, ref = _grads(full, x, [gamma, *whole], g)
        outs, dxs, dgs, dws = [], [], [], []
        for i in range(mp):
            shards = [shard_tensor(key, w, i, mp) for key, w in zip(keys, whole)]
            o, grads = _grads(part, x, [gamma, *shards], g)
            outs.append(o.float())
            dxs.append(grads[0].float())
            dgs.append(grads[1])
            dws.append(grads[2:])
        torch.cuda.synchronize()
        summed = (x.float() + sum(outs) + bias).to(torch.bfloat16)
        _close(summed, out, STEP_TOL)
        _close((g.float() + sum(dxs)).to(torch.bfloat16), ref[0], STEP_TOL)
        assert _rel_l2(sum(dgs), ref[1]) <= GRAD_REL_L2
        for j, key in enumerate(keys):
            got = unshard_tensor(key, [d[j] for d in dws])
            assert _rel_l2(got, ref[2 + j]) <= GRAD_REL_L2, key


# fp32 rows of the unfused route (#6-#9, ops/cuda/unfused_fp32.py on
# csrc/step_fp32.cu): fp32 on both sides, FP32_TOL / FP32_REL_L2 as the
# fused steps' fp32 rows.  Head dims 12 and 16 (DP 16), 24 (32), 64 (64);
# L 1, the 129- and 513-position tails of 64-row tiles, and a copy of
# contiguous q, k, v beside the MHSA's views.
FP32_FLASH_SHAPES = [(2, 3, 65, 12, True), (1, 16, 130, 16, True), (2, 2, 37, 24, False),
                     (3, 4, 1, 16, True), (1, 2, 200, 64, True), (2, 4, 513, 12, True),
                     (1, 4, 129, 12, False), (1, 2, 1000, 64, True)]


@pytest.mark.parametrize("r,h,seq,d,rope", FP32_FLASH_SHAPES)
def test_fp32_flash_attention_kernels(dev, r, h, seq, d, rope):
    """#6 and #7 on fp32 views of a QKV product against autograd through the
    plain version in fp32: one counted fp32 launch each way, none of the
    bf16 kernels; contiguous q, k, v give the same bits."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    g = torch.Generator().manual_seed(11)
    qkv = (1.5 * torch.randn(r, seq, 3, h, d, generator=g)).to(dev)
    go = torch.randn(r, h, seq, d, generator=g).to(dev)
    counters = (U.flash_forward_fp32, U.flash_backward_fp32, FA.flash_attention,
                FA.flash_attention_backward)
    before = [f.launches for f in counters]
    leaf = qkv.detach().requires_grad_(True)
    q, k, v = leaf.permute(2, 0, 3, 1, 4)
    out = FA.flash_attention(q, k, v, rope)
    (got,) = torch.autograd.grad(out, leaf, go)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 1, 0, 0]
    ref_leaf = qkv.detach().requires_grad_(True)
    rq, rk, rv = ref_leaf.permute(2, 0, 3, 1, 4)
    ref_out = FA.reference_flash_attention(rq, rk, rv, rope)
    (ref,) = torch.autograd.grad(ref_out, ref_leaf, go)
    _close(out, ref_out, FP32_TOL)
    for i in range(3):
        if seq == 1 and i < 2:   # softmax over one key: no gradient reaches q or k
            assert got[:, :, i].abs().max() < 1e-6
        else:
            assert _rel_l2(got[:, :, i], ref[:, :, i]) <= FP32_REL_L2, i
    with torch.no_grad():
        dense = FA.flash_attention(*(t.detach().contiguous() for t in (q, k, v)), rope)
    assert torch.equal(dense, out.detach())


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 37, 48, 192, 4), (2, 130, 256, 96, 4),
                                             (3, 5, 16, 32, 8), (1, 61, 256, 1024, 4),
                                             (2, 70, 96, 30, 3), (1, 9, 112, 36, 2)])
def test_fp32_swiglu_ffn_kernels(dev, r, seq, c, inner, k, drop):
    """#8 and #9 on fp32 pre-padded rows against autograd through the plain
    version in fp32 (cuDNN without TF32), the inner mask at rows offset by
    7, an inner width padded to whole float4s (30); one counted fp32 launch
    each way and none of the bf16 kernels."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    x, w = _core_inputs(dev, r, seq, c, inner, k)
    x = x.float()
    go = torch.randn(*x.shape, generator=torch.Generator().manual_seed(12)).to(dev)
    counters = (U.ffn_core_fp32, U.ffn_core_fp32_backward, SF.swiglu_conv_deconv,
                SF.swiglu_ffn_backward)
    before = [f.launches for f in counters]
    out, got = _all_grads(lambda *a: SF.swiglu_conv_deconv(*a, k, drop, 1234, 7), [x, *w], go)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 1, 0, 0]
    ref_out, ref = _all_grads(lambda *a: SF.reference_swiglu_conv_deconv(*a, k, drop, 1234, 7),
                              [x, *w], go)
    _check_fp32(out, ref_out, got, ref, ("dx", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b"))


def test_fp32_unfused_kernels_give_the_same_bits_twice(dev):
    """No atomics in the fp32 chains: two #7 runs and two #9 runs (dropout
    0.1, 3 row groups) are bit-equal; #9 in row groups differs from the
    one-group run only by the order of its fp32 sums; the layouts' bytes are
    the compiled kernels' own."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    for d in (12, 16, 24, 64):
        assert U.flash_launch_bytes(d) == U.compiled_flash_launch_bytes(d)
    g = torch.Generator().manual_seed(13)
    qkv = (1.5 * torch.randn(2, 300, 3, 4, 16, generator=g)).to(dev)
    go = torch.randn(2, 300, 4, 16, generator=g).to(dev)
    q4, k4, v4 = qkv.permute(2, 0, 3, 1, 4)
    out, lse = FA._forward(q4, k4, v4, True, 10000.0, True)
    first = FA.flash_attention_backward(go, q4, k4, v4, out, lse, True, 10000.0)
    again = FA.flash_attention_backward(go, q4, k4, v4, out, lse, True, 10000.0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    r, seq, c, inner, k = 5, 200, 256, 128, 4
    x, w = _core_inputs(dev, r, seq, c, inner, k)
    x = x.float()
    go = torch.randn(*x.shape, generator=g).to(dev)
    lin = x.shape[1]
    cap = 2 * 4 * 5 * (lin - k + 1) * inner
    assert U.core_rows(r, lin, c, inner, k, True, cap) == 2
    first = SF.swiglu_ffn_backward(go, x, *w[:3], k, 0.1, 1234, 7, scratch_cap=cap)
    again = SF.swiglu_ffn_backward(go, x, *w[:3], k, 0.1, 1234, 7, scratch_cap=cap)
    whole = SF.swiglu_ffn_backward(go, x, *w[:3], k, 0.1, 1234, 7)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(first[0], whole[0])
    assert all(_rel_l2(a, b) < 1e-5 for a, b in zip(first[1:], whole[1:]))


# The 3xTF32 attention core of csrc/attn_fp32.cu (the core of #3/#4 and #6/#7
# at fp32) alone, through step_fp32.CudaPrims on operands laid out as
# qkv_split writes them ([R, H, Lp, DP], rows past L and dims past D zero),
# against autograd in float64 on the same values: head dims 12 (a k8 and a
# k4 step), 16, 24 (3 of DP 32's 4 steps), 32 and 64; L 1, the 65- and
# 129-position tails, 2049 (xlarge freq's); the probability mask at rows
# offset by row0 against probability_mask's (the plain version's) at
# dropout 0.1; the tolerances of the fp32 rows above.
FP32_CORE_SHAPES = [(2, 3, 1, 12, 0.0), (1, 4, 65, 16, 0.0), (2, 2, 129, 24, 0.0),
                    (1, 2, 200, 32, 0.0), (1, 2, 130, 64, 0.0), (1, 1, 2049, 16, 0.0),
                    (3, 2, 517, 12, 0.0), (2, 2, 65, 12, 0.1), (2, 3, 129, 16, 0.1),
                    (1, 4, 300, 24, 0.1), (2, 2, 70, 32, 0.1), (1, 2, 129, 64, 0.1),
                    (1, 1, 2049, 16, 0.1)]


def _fp32_core_case(dev, r, h, seq, d, p, seed=15):
    """Operands, the kernels' outputs and the float64 reference's of one
    core case; RoPE's tables at the identity (the step and flash tests above
    hold the rotation)."""
    from mss_tf_locoformer_tpu_torch.ops import dropout as D
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    g = torch.Generator().manual_seed(seed)
    dp, lp, a, row0 = U.head_pad(d), -(-seq // 64) * 64, h * d, 5
    q, k, v = (torch.zeros(r, h, lp, dp) for _ in range(3))
    for t in (q, k, v):
        t[:, :, :seq, :d] = 1.5 * torch.randn(r, h, seq, d, generator=g)
    dout = torch.randn(r, seq, a, generator=g)
    q, k, v, dout = (t.to(dev) for t in (q, k, v, dout))
    scale, drop = d ** -0.5, D.kernel_args(p, 4321, row0)
    P = S.CudaPrims()

    def run():
        o = torch.empty(r, seq, a, device=dev)
        lse = torch.empty(r, h, seq, device=dev)
        P.attn_fwd(q, k, v, o, lse, r, h, seq, lp, d, scale, drop)
        dop, delta = torch.empty(r, h, lp, dp, device=dev), torch.empty(r, h, seq, device=dev)
        dqkv = torch.empty(r, seq, 3 * a, device=dev)
        cos, sin = torch.ones(seq, d // 2, device=dev), torch.zeros(seq, d // 2, device=dev)
        P.attn_bwd(q, k, v, o, dout, lse, dop, delta, dqkv, cos, sin, r, h, seq, lp, d, scale,
                   drop)
        torch.cuda.synchronize()
        return o, lse, dqkv.view(r, seq, 3, h, d).permute(2, 0, 3, 1, 4)

    leaves = [t[:, :, :seq, :d].double().requires_grad_(True) for t in (q, k, v)]
    s = leaves[0] @ leaves[1].transpose(-1, -2) * scale
    lse = torch.logsumexp(s, -1)
    pr = torch.exp(s - lse[..., None])
    if p > 0:
        keep = AB.probability_mask(4321, torch.arange(r, device=dev) + row0, h, seq, p, dev)
        pr = torch.where(keep, pr / (1 - p), torch.zeros((), dtype=pr.dtype, device=dev))
    o = pr @ leaves[2]
    grads = torch.autograd.grad(o, leaves, dout.double().view(r, seq, h, d).transpose(1, 2))
    return run, (o.detach().transpose(1, 2).reshape(r, seq, a), lse.detach(), grads)


@pytest.mark.parametrize("r,h,seq,d,p", FP32_CORE_SHAPES)
def test_fp32_attention_core_kernels(dev, r, h, seq, d, p):
    """The core's forward (o and the natural log-sum-exp) and backward (dq,
    dk, dv) against float64 autograd; a second run gives the same bits."""
    run, (ref_o, ref_lse, ref_g) = _fp32_core_case(dev, r, h, seq, d, p)
    o, lse, dg = run()
    _close(o, ref_o, FP32_TOL)
    _close(lse, ref_lse, FP32_TOL)
    for i, name in enumerate(("dq", "dk", "dv")):
        assert torch.isfinite(dg[i]).all(), name
        if seq == 1 and i < 2:   # softmax over one key: no gradient reaches q or k
            assert dg[i].abs().max() < 1e-6, name
        else:
            assert _rel_l2(dg[i], ref_g[i]) <= FP32_REL_L2, (name, _rel_l2(dg[i], ref_g[i]))
    again = run()
    assert all(torch.equal(a_, b_) for a_, b_ in zip((o, lse, dg), again))


def test_fp32_attention_core_refuses_other_layouts(dev):
    """The core's entry points refuse what the layout does not hold: a head
    dim above the padded width, an odd one, a padded length that is no
    multiple of 64 or shorter than L."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    P = S.CudaPrims()
    q = torch.zeros(1, 1, 64, 16, device=dev)
    o = torch.empty(1, 8, 16, device=dev)
    for seq, lp, d in ((8, 64, 18), (8, 64, 7), (8, 48, 16), (70, 64, 16)):
        with pytest.raises(RuntimeError):
            P.attn_fwd(q, q, q, o, None, 1, 1, seq, lp, d, 0.25, (0, 0, 0, 1.0, 0))


def test_unfused_kernels_refuse_fp16(dev):
    """bf16 and fp32 take the unfused route's kernels; fp16 neither (no cast)."""
    q = torch.randn(1, 2, 8, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        FA.flash_attention(q, q, q, True)
    x, w = _core_inputs(dev, 1, 5, 48, 64, 4)
    with pytest.raises(TypeError):
        SF.swiglu_conv_deconv(x.half(), *w, 4)


# fp32 #8/#9 on the 3xTF32 GEMMs of csrc/ffn_core_fp32.cu at odd shapes:
# widths 4 and 12 (K = k C ends inside a 32-float stage, N = C inside a
# 64-wide tile), inner 30 (padded to 32), L 1, k 2 and 8; FP32_TOL /
# FP32_REL_L2 as above.
FP32_CORE_ODD = [(2, 1, 4, 30, 2), (3, 17, 12, 30, 8), (1, 1, 12, 64, 8), (2, 40, 4, 30, 4),
                 (2, 9, 12, 30, 2), (1, 65, 4, 30, 8)]


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("r,seq,c,inner,k", FP32_CORE_ODD)
def test_fp32_swiglu_ffn_kernels_odd_shapes(dev, monkeypatch, r, seq, c, inner, k, drop):
    """#8 and #9 on fp32 rows against autograd through the plain version in
    fp32: one counted launch each way, and no FFMA GEMM inside either call
    (every GEMM on the 3xTF32 kernels)."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    gemms = _no_ffma(monkeypatch)
    x, w = _core_inputs(dev, r, seq, c, inner, k)
    x = x.float()
    go = torch.randn(*x.shape, generator=torch.Generator().manual_seed(14)).to(dev)
    before = [U.ffn_core_fp32.launches, U.ffn_core_fp32_backward.launches]
    out, got = _all_grads(lambda *a: SF.swiglu_conv_deconv(*a, k, drop, 1234, 3), [x, *w], go)
    torch.cuda.synchronize()
    assert [U.ffn_core_fp32.launches - before[0],
            U.ffn_core_fp32_backward.launches - before[1]] == [1, 1]
    assert set(gemms) == {"gemm_nn", "gemm_tn"}
    ref_out, ref = _all_grads(lambda *a: SF.reference_swiglu_conv_deconv(*a, k, drop, 1234, 3),
                              [x, *w], go)
    _check_fp32(out, ref_out, got, ref, ("dx", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b"))


def test_fp32_core_layouts_match_the_compiled_kernels(dev):
    """The FFN-core gate's layout bytes are the compiled kernels' own, and a
    GEMM panel that is not a split panel is refused."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    assert U.core_launch_bytes() == U.compiled_core_launch_bytes()
    x = torch.zeros(1, 8, 8, device=dev)
    with pytest.raises(ValueError):
        U.CorePrims().gemm_nn(S.EPI_STORE, S.Win(x, 64, 8, 8, 0, 64), 8, 8,
                              torch.zeros(8, 8, device=dev), 8, torch.empty(8, 8, device=dev), 8)


# fp32 #2/#5 on the 3xTF32 GEMMs of csrc/ffn_core_fp32.cu (core_nn with the
# step's output epilogue, core_tn, core_colsum) and step_fp32.cu's norms,
# outer mask and reductions: C 32 / 64 (tile 64), 96 (tile 96), 128 (tile
# 128), k 4 and 8, L 1 to 2049 (the conv's window starts k - 1 positions
# before the row), the partial-sum mode; FP32_TOL / FP32_REL_L2 as above.
FP32_STEP_3X = [(2, 1, 32, 64, 4), (3, 17, 64, 128, 8), (2, 65, 96, 384, 4),
                (1, 2049, 96, 384, 4), (2, 130, 128, 256, 8), (1, 2049, 128, 384, 8)]


def _no_ffma(monkeypatch):
    """No FFMA GEMM is left to run: step_fp32.cu's library exports none
    (``f32_gemm_nn`` / ``f32_gemm_tn``) and ``step_fp32.CudaPrims`` binds
    none, so every GEMM of an fp32 chain is a launch of ``unfused_fp32.
    CorePrims`` (3xTF32 ``core_nn`` / ``core_tn``); returns the names of
    those launches from here on."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import load
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    assert not any(hasattr(load("step_fp32"), n) for n in ("f32_gemm_nn", "f32_gemm_tn"))
    assert not any(hasattr(S.CudaPrims, n) for n in ("gemm_nn", "gemm_tn"))
    core = []
    for name in ("gemm_nn", "gemm_tn"):
        real = getattr(U.CorePrims, name)
        monkeypatch.setattr(U.CorePrims, name,
                            lambda self, *a, _n=name, _f=real, **kw: core.append(_n) or _f(
                                self, *a, **kw))
    return core


@pytest.mark.parametrize("drop,residual", [(0.0, True), (0.1, True), (0.1, False)])
@pytest.mark.parametrize("r,seq,c,inner,k", FP32_STEP_3X)
def test_fp32_ffn_step_on_tensor_cores(dev, monkeypatch, r, seq, c, inner, k, drop, residual):
    """#2 and #5 on fp32 rows against autograd through the plain version in
    fp32: one counted launch each way, and no FFMA GEMM inside either call
    (every GEMM on the 3xTF32 kernels)."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    gemms = _no_ffma(monkeypatch)
    x, params, g = _ffn_inputs(dev, r, seq, c, inner, k, seed=11)
    x, g = x.float(), g.float()
    if not residual:
        params = params[:4] + [None]
    args = (k, 4, 1e-5, drop, 4321, 9, residual)
    grad_params = [p for p in params if p is not None]
    fn = lambda kern: lambda x_, *p: kern(x_, *p, *([None] if not residual else []), *args)
    counts = (S.ffn_forward.launches, S.ffn_backward.launches)
    out, got = _grads(fn(FB.fused_norm_ffn_residual), x, grad_params, g)
    torch.cuda.synchronize()
    assert (S.ffn_forward.launches, S.ffn_backward.launches) == (counts[0] + 1, counts[1] + 1)
    assert set(gemms) == {"gemm_nn", "gemm_tn"}
    ref_out, ref = _grads(fn(FB.reference_norm_ffn_residual), x, grad_params, g)
    _check_fp32(out, ref_out, got, ref,
                ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b"))


def _output_epilogue_mask(dev, c, site, kk):
    """``core_nn``'s output epilogue at dropout 0.1 on zero products (K
    ``kk``) with a bias of ones at ``site``: every output is the site's keep
    bit times 1 / (1 - p), bit for bit ``keep_mask`` at (row0 + row,
    position, channel); with no residual the products alone (no bias, no
    mask)."""
    from mss_tf_locoformer_tpu_torch.ops import dropout as D
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    r, seq, p, row0 = 3, 301, 0.1, 5
    a = torch.randn(r, seq, kk, device=dev)
    b = U.split_panel(torch.zeros(kk, c, device=dev))
    bias, res = torch.ones(c, device=dev), torch.zeros(r, seq, c, device=dev)
    drop = D.kernel_args(p, 77, row0)
    P = U.CorePrims()
    out = torch.empty(r, seq, c, device=dev)
    P.gemm_nn(S.EPI_OUT, S.Win(a, seq * kk, seq, kk, 0, seq * kk), r * seq, kk, b, c, out, c,
              bias=bias, res=res, p=seq, site=site, drop=drop)
    keep = D.row_mask(77, site, out, row0, p)
    torch.cuda.synchronize()
    assert torch.equal(out != 0, keep)
    assert torch.equal(out[keep], torch.full_like(out[keep], drop[3]))
    P.gemm_nn(S.EPI_OUT, S.Win(a, seq * kk, seq, kk, 0, seq * kk), r * seq, kk, b, c, out, c,
              bias=bias, p=seq, site=site, drop=drop)
    torch.cuda.synchronize()
    assert not out.any()


@pytest.mark.parametrize("c", [32, 64, 96, 128])
def test_fp32_output_epilogue_mask_is_keep_mask(dev, c):
    """The FFN step's output epilogue (the deconv's K, 8 C) at the outer
    site."""
    from mss_tf_locoformer_tpu_torch.ops import dropout as D
    _output_epilogue_mask(dev, c, D.SITE_FFN_OUTER, 8 * c)


@pytest.mark.parametrize("c,a", [(32, 32), (64, 64), (96, 96), (128, 128), (96, 24)])
def test_fp32_projection_epilogue_mask_is_keep_mask(dev, c, a):
    """The attention step's out-projection (K = A, no bias in the step) at
    the projection site, the mp 4 shard's A 24 among them."""
    from mss_tf_locoformer_tpu_torch.ops import dropout as D
    _output_epilogue_mask(dev, c, D.SITE_ATTN_PROJ, a)


@pytest.mark.parametrize("c,inner,k", [(96, 384, 4), (32, 64, 8)])
def test_fp32_ffn_step_reruns_bit_equal(dev, monkeypatch, c, inner, k):
    """Two #5 runs at dropout 0.1 in 3 row groups give the same bits (no
    atomics: per-split partials summed in a fixed order); a one-group run
    differs only by the order of its sums; no FFMA GEMM runs."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    gemms = _no_ffma(monkeypatch)
    r, seq = 5, 257
    x, params, g = _ffn_inputs(dev, r, seq, c, inner, k, seed=12)
    x, g = x.float(), g.float()
    cap = 2 * 4 * (3 * seq * c + 5 * (seq + k - 1) * inner)
    assert S.ffn_rows(r, seq, c, inner, k, True, cap) == 2
    args = (g, x, *params[:4], k, 4, 1e-5, 0.1, 1234, 7)
    first = FB.ffn_step_backward(*args, scratch_cap=cap)
    again = FB.ffn_step_backward(*args, scratch_cap=cap)
    whole = FB.ffn_step_backward(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(_rel_l2(a, b) < 1e-5 for a, b in zip(first[1:], whole[1:]))
    assert set(gemms) == {"gemm_nn", "gemm_tn"}


def test_fp32_ffn_step_layouts_match_the_compiled_kernels(dev):
    """The fp32 FFN-step gate's layout bytes (``core_nn`` at each GEMM's tile,
    ``core_tn``, the norm backward) are the compiled kernels' own."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    for c in S.CHANNELS:
        for inner in (64, 96, 192, 384, 1024):
            for training in (False, True):
                assert S.ffn_launch_bytes(c, inner, training) == \
                    S.compiled_ffn_launch_bytes(c, inner, training)


# fp32 #3/#4 on the 3xTF32 GEMMs of csrc/ffn_core_fp32.cu (core_nn: QKV, the
# out-projection with the output epilogue at the projection site, do, dxn;
# core_tn: the weight products) around csrc/attn_fp32.cu's core, with
# csrc/step_fp32.cu's norms (a warp per position): against autograd through
# the plain version in float64, outputs and dx within FP32_STEP_TOL of
# max|ref|, the other gradients within FP32_STEP_TOL relative L2 (fp32 on
# the kernels' side, float64 on the other: ~1e-6); C 32 to 128, L 1 to 2049,
# the mp 4 shard's one head of 24, the partial-sum mode.
FP32_STEP_TOL = 1e-5
FP32_ATTN_3X = [(1, 1, 32, 32, 2), (2, 65, 64, 64, 4), (2, 130, 96, 96, 4),
                (1, 2049, 96, 96, 4), (2, 129, 128, 128, 4), (1, 1025, 128, 128, 8),
                (3, 37, 96, 24, 1)]


@pytest.mark.parametrize("drop,residual", [(0.0, True), (0.1, True), (0.1, False)])
@pytest.mark.parametrize("r,seq,c,a,h", FP32_ATTN_3X)
def test_fp32_attention_step_on_tensor_cores(dev, monkeypatch, r, seq, c, a, h, drop,
                                             residual):
    """#3 and #4 on fp32 rows against autograd through the plain version in
    float64: one counted launch each way, none of the bf16 kernels', every
    GEMM on the 3xTF32 kernels (``core_nn`` four times, ``core_tn`` twice)
    and no FFMA GEMM."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    gemms = _no_ffma(monkeypatch)
    x, params, g = _attn_inputs(dev, r, seq, c, a, seed=16)
    x, g = x.float(), g.float()
    args = (h, 4, 1e-5, True, 10000.0, drop, 4321, 9, residual)
    counts = (S.attention_forward.launches, S.attention_backward.launches,
              AB.fused_attention_block.launches)
    out, got = _grads(lambda *p: AB.fused_attention_block(*p, *args), x, params, g)
    torch.cuda.synchronize()
    assert (S.attention_forward.launches, S.attention_backward.launches,
            AB.fused_attention_block.launches) == (counts[0] + 1, counts[1] + 1, counts[2])
    assert sorted(gemms) == ["gemm_nn"] * 4 + ["gemm_tn"] * 2
    ref_out, ref = _grads(lambda *p: AB.reference_attention_block(*p, *args), x.double(),
                          [t.double() for t in params], g.double())
    _check_fp32(out, ref_out, got, ref, ("dx", "dgamma", "dw_qkv", "dw_out"), FP32_STEP_TOL,
                FP32_STEP_TOL)


def test_fp32_attention_step_reruns_bit_equal(dev, monkeypatch):
    """Two #4 runs at dropout 0.1 give the same bits (the weight products'
    per-split partials and the dgamma partials summed in a fixed order, no
    atomics); no FFMA GEMM runs."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    gemms = _no_ffma(monkeypatch)
    x, (gamma, w_qkv, w_out), g = _attn_inputs(dev, 4, 513, 128, 128, seed=17)
    x, g = x.float(), g.float()
    args = (4, 4, 1e-5, True, 10000.0, 0.1, 5, 3)
    _, stash = S.attention_forward(x, gamma, w_qkv, w_out, *args, stash=True)
    first = S.attention_backward(g, x, gamma, w_qkv, w_out, stash, *args)
    again = S.attention_backward(g, x, gamma, w_qkv, w_out, stash, *args)
    torch.cuda.synchronize()
    assert all(torch.equal(a_, b_) for a_, b_ in zip(first, again))
    assert gemms.count("gemm_tn") == 4


def _norm_f64(x, gamma, groups, eps):
    g = x.unflatten(-1, (groups, x.shape[-1] // groups))
    rms = g.pow(2).sum(-1, keepdim=True).sqrt() * (g.shape[-1] ** -0.5)
    return (g / (rms + eps)).flatten(-2) * gamma


# (C, groups): every width the gates admit at 1, 2 and 4 groups; 3 groups of
# 32; groups that straddle a lane's float4 (C 32 / 16 groups: 2 channels
# each, C 96 / 32: 3)
FP32_NORMS = [(c, g) for c in (32, 64, 96, 128) for g in (1, 2, 4)] + [(96, 3), (32, 16),
                                                                       (96, 32)]


@pytest.mark.parametrize("c,groups", FP32_NORMS)
def test_fp32_norm_kernels(dev, c, groups):
    """``norm_fwd`` and ``norm_bwd`` (a warp per position) against the norm in
    float64 and its autograd, with and without the residual's gradient:
    xn and dx within FP32_STEP_TOL of max|ref|, dgamma (the blocks'
    partials summed in a fixed order) within FP32_STEP_TOL relative L2; a
    ragged last block; a zero row (rms 0: dx is the upstream gradient times
    gamma over eps, held on its own); a second run gives the same bits."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    P = S.CudaPrims()
    npos = 5000 * S.NP + 7
    gen = torch.Generator().manual_seed(c + groups)
    x, dxn, gres = (torch.randn(npos, c, generator=gen).to(dev) for _ in range(3))
    x[3] = 0.0   # a zero row: xn 0, dx the upstream gradient over eps
    gamma = (1 + 0.1 * torch.randn(c, generator=gen)).to(dev)
    xn = torch.empty_like(x)
    P.norm_fwd(x, gamma, xn, npos, c, groups, 1e-5)
    xl, gl = x.double().requires_grad_(True), gamma.double().requires_grad_(True)
    ref = _norm_f64(xl, gl, groups, 1e-5)
    ref_dx, ref_dg = torch.autograd.grad(ref, (xl, gl), dxn.double())
    torch.cuda.synchronize()
    _close(xn, ref.detach(), FP32_STEP_TOL)
    part = torch.empty(-(-npos // S.NP), c, device=dev)
    for res in (None, gres):
        dx = torch.empty_like(x)
        P.norm_bwd(x, gamma, dxn, res, dx, part, npos, c, groups, 1e-5)
        dg = S._reduce(P, part, torch.empty(c, device=dev))
        torch.cuda.synchronize()
        want = ref_dx.clone()
        want[3] = dxn[3].double() * gl.detach() / 1e-5   # d(x / eps * gamma) at x = 0
        if res is not None:
            want += res.double()
        rows = torch.arange(npos, device=dev) != 3
        _close(dx[rows], want[rows], FP32_STEP_TOL)
        _close(dx[3], want[3], FP32_STEP_TOL)
        assert _rel_l2(dg, ref_dg) <= FP32_STEP_TOL, _rel_l2(dg, ref_dg)
    again = torch.empty_like(x)
    P.norm_bwd(x, gamma, dxn, gres, again, part, npos, c, groups, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(again, dx)


def test_fp32_norm_kernels_refuse_other_layouts(dev):
    """The norms take C of whole float4s up to 128 and whole groups, on
    16-byte aligned rows; anything else raises (no launch)."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    P = S.CudaPrims()
    x = torch.zeros(4, 260, device=dev)
    gamma = torch.ones(260, device=dev)
    for c, groups, off in ((132, 1, 0), (30, 1, 0), (32, 3, 0), (32, 1, 1)):
        with pytest.raises(RuntimeError):
            P.norm_fwd(x.reshape(-1)[off:], gamma, torch.empty_like(x), 2, c, groups, 1e-5)


def test_fp32_attention_layouts_match_the_compiled_kernels(dev):
    """The fp32 attention-step gate's layout bytes (``core_nn`` at each GEMM's
    tile, ``core_tn``, the core's, the norm backward's partials) and the
    norm blocks' positions are the compiled kernels' own."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    assert S.compiled_norm_positions() == S.NP
    for c in S.CHANNELS:
        for a in (24, 32, 48, 96, 128):
            for training in (False, True):
                assert S.launch_bytes(c, a, training) == S.compiled_launch_bytes(c, a, training)
