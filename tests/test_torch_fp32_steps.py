"""fp32 rows of the fused steps (#2-#5, ``ops/cuda/step_fp32.py``) on the CPU.

* The chains of the four steps run on the kernels' arithmetic emulated in
  plain torch (:class:`TorchPrims`, one method per kernel of
  ``csrc/step_fp32.cu``: the windowed GEMMs and their epilogues, the
  per-split partials and their fixed-order sums, the norm, the masks, the
  attention core with the undropped denominator): outputs and gradients
  against autograd through the plain versions, with dropout, in the
  partial-sum mode, in row groups and at a sequence that is no multiple of
  the 64-row tiles.  That holds the panels, windows, shifts, RoPE's
  inverse and the unpacking of the weight gradients; the kernels' own
  arithmetic is held on the card (``chip_smoke.py``,
  ``tests/test_torch_cuda_kernels.py``).
* The fp32 gates at every shipped config's widths (the layouts' bytes
  pinned), and the route an fp32 model takes (``tests/torch_routes.py``).
* The speech loader's fp32 default against the JAX loader's, and the fp32
  separator against the JAX separator; one ``use_amp: false`` step through
  ``precision_from_amp`` against ``make_train_step``.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mss_tf_locoformer_tpu_torch.core import config as C
from mss_tf_locoformer_tpu_torch.nn.norms import rms_group_norm
from mss_tf_locoformer_tpu_torch.ops import dropout as D
from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
from mss_tf_locoformer_tpu_torch.ops.rope import apply_rope
from torch_routes import spy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5        # of max|ref|: fp32 on both sides, sums in another order


def _win(w: S.Win, m: int, k: int) -> torch.Tensor:
    """The ``[m, k]`` matrix a window describes (zero outside ``[0, lim)``)."""
    flat = w.t.reshape(-1)
    q = torch.arange(m)
    off = (q % w.P * w.ps + w.shift)[:, None] + torch.arange(k)[None]
    ok = (off >= 0) & (off < w.lim)
    idx = (q // w.P * w.rs)[:, None] + off.clamp(min=0)
    return torch.where(ok, flat[idx.clamp(max=flat.numel() - 1)], torch.zeros(()))


def _keep(drop, site, row, a, b, c=0):
    seed, thr, row0, _, _ = drop
    t = [torch.as_tensor(v) for v in (row + row0, a, b, c)]
    return D._keep(seed, site, *t, thr)


class TorchPrims:
    """The kernels of ``csrc/step_fp32.cu`` in plain torch, with the
    wrappers' argument conventions (``step_fp32.CudaPrims``)."""

    def __init__(self):
        self.calls = {}

    def _count(self, name):
        self.calls[name] = self.calls.get(name, 0) + 1

    def gemm_nn(self, epi, a, m, k, b, n, out, ldo, bias=None, y=None, res=None, p=1,
                site=0, drop=(0, 0, 0, 1.0, 0)):
        self._count("gemm_nn")
        assert k % 4 == 0 and n % 4 == 0
        acc = _win(a, m, k) @ b
        q = torch.arange(m)
        rows, pos = (q // p)[:, None], (q % p)[:, None]
        o2 = out.reshape(-1)[:m * ldo].view(m, ldo)
        on, scale = drop[4], drop[3]
        if epi == S.EPI_STORE:
            o2[:, :n] = acc + (0 if bias is None else bias)
        elif epi == S.EPI_OUT:
            v = acc + (0 if bias is None else bias)
            if res is not None:
                if on:
                    v = torch.where(_keep(drop, site, rows, pos, torch.arange(n)[None]),
                                    v * scale, torch.zeros(()))
                v = v + res.reshape(m, n)
            o2[:, :n] = v
        elif epi == S.EPI_SWIGLU:
            v = acc + bias
            if y is not None:
                y.reshape(-1)[:m * n].view(m, n)[:] = v
            h = v[:, 0::2] * F.silu(v[:, 1::2])
            if on:
                h = torch.where(_keep(drop, site, rows, pos, torch.arange(n // 2)[None]),
                                h * scale, torch.zeros(()))
            o2[:, :n // 2] = h
        else:
            dh = acc
            if on:
                dh = torch.where(_keep(drop, site, rows, pos, torch.arange(n)[None]),
                                 dh * scale, torch.zeros(()))
            y2 = y.reshape(-1)[:m * 2 * n].view(m, 2 * n)
            v, g = y2[:, 0::2], y2[:, 1::2]
            s = torch.sigmoid(g)
            o2[:, 0:2 * n:2] = dh * g * s
            o2[:, 1:2 * n:2] = dh * v * s * (1 + g * (1 - s))

    def gemm_tn(self, a, m, b, n, total, splits, part):
        self._count("gemm_tn")
        aw, bw = _win(a, total, m), _win(b, total, n)
        per = -(-total // splits)
        for s in range(splits):
            part[s] = aw[s * per:(s + 1) * per].T @ bw[s * per:(s + 1) * per]

    def colsum(self, a, w, total, splits, part):
        self._count("colsum")
        aw = _win(a, total, w)
        per = -(-total // splits)
        for s in range(splits):
            part[s] = aw[s * per:(s + 1) * per].sum(0)

    def reduce(self, part, s, n, seg, out):
        self._count("reduce")
        p2 = part.reshape(-1)[:s * n].view(s, n)
        o2 = out.reshape(-1, n)
        for gi in range(-(-s // seg)):
            o2[gi] = p2[gi * seg:(gi + 1) * seg].sum(0)

    def norm_fwd(self, x, gamma, xn, npos, c, groups, eps):
        self._count("norm_fwd")
        xn.reshape(-1)[:npos * c] = rms_group_norm(x.reshape(npos, c), gamma, groups,
                                                   eps).reshape(-1)

    def norm_bwd(self, x, gamma, dxn, gres, dx, part, npos, c, groups, eps):
        self._count("norm_bwd")
        x2 = x.reshape(npos, c).detach().requires_grad_(True)
        g2 = gamma.detach().requires_grad_(True)
        up = dxn.reshape(-1)[:npos * c].view(npos, c)
        gx, _ = torch.autograd.grad(rms_group_norm(x2, g2, groups, eps), [x2, g2], up)
        if gres is not None:
            gx = gx + gres.reshape(npos, c)
        dx.copy_(gx.reshape(dx.shape))
        contrib = up * rms_group_norm(x2.detach(), torch.ones(c), groups, eps)
        blocks = -(-npos // S.NP)
        part.copy_(F.pad(contrib, (0, 0, 0, blocks * S.NP - npos)).view(blocks, S.NP, c).sum(1))

    def mask_rows(self, g, dz, n, seq, c, site, drop):
        self._count("mask_rows")
        r = n // (seq * c)
        keep = _keep(drop, site, torch.arange(r)[:, None, None], torch.arange(seq)[None, :, None],
                     torch.arange(c)[None, None])
        dz.copy_(torch.where(keep, g * drop[3], torch.zeros(())))

    def qkv_split(self, qkv, cos, sin, q, k, v, r, seq, lp, h, d):
        self._count("qkv_split")
        t = qkv.view(r, seq, 3, h, d).permute(2, 0, 3, 1, 4)

        def rot(z):
            e, o = z[..., 0::2], z[..., 1::2]
            return torch.stack([e * cos - o * sin, o * cos + e * sin], -1).flatten(-2)
        for dst, src in ((q, rot(t[0])), (k, rot(t[1])), (v, t[2])):
            dst.zero_()
            dst[:, :, :seq, :d] = src

    def _scores(self, q, k, r, h, seq, d, scale):
        return (q[:, :, :seq, :d] * scale) @ k[:, :, :seq, :d].transpose(-1, -2)

    def _prob_keep(self, drop, r, h, seq):
        return _keep(drop, D.SITE_ATTN_PROB, torch.arange(r)[:, None, None, None],
                     torch.arange(h)[None, :, None, None], torch.arange(seq)[None, None, None],
                     torch.arange(seq)[None, None, :, None])

    def attn_fwd(self, q, k, v, o, lse, r, h, seq, lp, d, scale, drop):
        self._count("attn_fwd")
        s = self._scores(q, k, r, h, seq, d, scale)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        if drop[4]:
            p = torch.where(self._prob_keep(drop, r, h, seq), p * drop[3], torch.zeros(()))
        o.copy_((p @ v[:, :, :seq, :d] / l).transpose(1, 2).reshape(r, seq, h * d))
        if lse is not None:
            lse.copy_((m + torch.log(l))[..., 0])

    def attn_bwd(self, q, k, v, o, dout, lse, dop, delta, dqkv, cos, sin, r, h, seq, lp, d,
                 scale, drop):
        self._count("attn_bwd")
        a = h * d
        do = dout.view(r, seq, h, d).transpose(1, 2)
        oh = o.view(r, seq, h, d).transpose(1, 2)
        dl = (do * oh).sum(-1)
        delta.copy_(dl)
        dop.zero_()
        dop[:, :, :seq, :d] = do
        p = torch.exp(self._scores(q, k, r, h, seq, d, scale) - lse[..., None])
        vv, kk, qq = v[:, :, :seq, :d], k[:, :, :seq, :d], q[:, :, :seq, :d]
        dp, pd = do @ vv.transpose(-1, -2), p
        if drop[4]:
            keep = self._prob_keep(drop, r, h, seq)
            dp = torch.where(keep, dp * drop[3], torch.zeros(()))
            pd = torch.where(keep, p * drop[3], torch.zeros(()))
        ds = p * (dp - dl[..., None])
        dq, dk, dv = ds @ kk * scale, ds.transpose(-1, -2) @ qq * scale, pd.transpose(-1, -2) @ do

        def unrot(z):
            e, od = z[..., 0::2], z[..., 1::2]
            return torch.stack([e * cos + od * sin, od * cos - e * sin], -1).flatten(-2)
        flat = lambda z: z.transpose(1, 2).reshape(r, seq, a)
        dqkv.copy_(torch.cat([flat(unrot(dq)), flat(unrot(dk)), flat(dv)], -1))


def _ffn_inputs(gen, r, seq, c, inner, k):
    x = torch.randn(r, seq, c, generator=gen) * 0.5
    gamma = 1 + 0.1 * torch.randn(c, generator=gen)
    b = (c * k) ** -0.5
    w = [(torch.rand(*s, generator=gen) * 2 - 1) * b
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    return x, gamma, w


def _grads(fn, x, params, g):
    x = x.detach().requires_grad_(True)
    ps = [p.detach().requires_grad_(True) for p in params]
    out = fn(x, *ps)
    return out, torch.autograd.grad(out, [x, *ps], g)


def _close(got, ref, what):
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL:g} x {scale:.3e}"


# (rows, seq, C, inner, k, groups, dropout, residual, scratch cap): a row
# group split (the 4 KB cap), a sequence no multiple of 64, both dropout
# sites, the partial-sum mode
FFN_CASES = [(3, 70, 32, 64, 4, 4, 0.0, True, 1 << 30),
             (5, 19, 64, 96, 8, 1, 0.2, True, 1 << 14),
             (4, 33, 32, 128, 3, 2, 0.1, False, 1 << 30)]


@pytest.mark.parametrize("r,seq,c,inner,k,groups,p,residual,cap", FFN_CASES)
def test_ffn_chain_matches_plain(r, seq, c, inner, k, groups, p, residual, cap):
    gen = torch.Generator().manual_seed(r * 31 + seq)
    x, gamma, (cw, cb, dw, db) = _ffn_inputs(gen, r, seq, c, inner, k)
    db = db if residual else None
    args = (k, groups, 1e-5, p, 1234, 7, residual)
    if cap < 1 << 30:
        assert S.ffn_rows(r, seq, c, inner, k, True, cap) < r   # groups really split
    prims = TorchPrims()
    out = S.ffn_forward(x, gamma, cw, cb, dw, db, *args, prims=prims, scratch_cap=cap)
    params = [gamma, cw, cb, dw] + ([db] if residual else [])
    ref_out, ref = _grads(lambda x_, g_, a_, b_, c_, *d_: FB.reference_norm_ffn_residual(
        x_, g_, a_, b_, c_, d_[0] if d_ else None, *args), x, params,
        torch.randn(r, seq, c, generator=gen))
    _close(out, ref_out, "forward")
    g = torch.randn(r, seq, c, generator=gen)
    ref_out, ref = _grads(lambda x_, g_, a_, b_, c_, *d_: FB.reference_norm_ffn_residual(
        x_, g_, a_, b_, c_, d_[0] if d_ else None, *args), x, params, g)
    got = S.ffn_backward(g, x, gamma, cw, cb, dw, *args, prims=prims, scratch_cap=cap)
    names = ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b")
    for name, a, b in zip(names, got, ref):
        _close(a, b, name)
    if not residual:
        assert not got[5].any()
    assert prims.calls["gemm_nn"] > 0 and prims.calls["reduce"] > 0


# (rows, seq, C, A, heads, groups, rope, dropout, residual)
ATTN_CASES = [(2, 70, 32, 32, 2, 4, True, 0.0, True),
              (3, 17, 96, 96, 4, 1, True, 0.1, True),
              (2, 40, 64, 48, 2, 2, False, 0.2, False)]


@pytest.mark.parametrize("r,seq,c,a,h,groups,rope,p,residual", ATTN_CASES)
def test_attention_chain_matches_plain(r, seq, c, a, h, groups, rope, p, residual):
    gen = torch.Generator().manual_seed(r * 17 + seq)
    x = torch.randn(r, seq, c, generator=gen) * 0.5
    gamma = 1 + 0.1 * torch.randn(c, generator=gen)
    wq = (torch.rand(3 * a, c, generator=gen) * 2 - 1) * 2 * c ** -0.5
    wo = (torch.rand(c, a, generator=gen) * 2 - 1) * a ** -0.5
    args = (h, groups, 1e-5, rope, 10000.0, p, 99, 3, residual)
    prims = TorchPrims()
    g = torch.randn(r, seq, c, generator=gen)
    ref_out, ref = _grads(lambda *t: AB.reference_attention_block(*t, *args), x,
                          [gamma, wq, wo], g)
    out, stash = S.attention_forward(x, gamma, wq, wo, *args, stash=True, prims=prims)
    _close(out, ref_out, "forward")
    _close(S.attention_forward(x, gamma, wq, wo, *args, prims=prims), ref_out, "forward")
    q, k, v, o, lse = stash
    lp = -(-seq // S.QT) * S.QT
    assert q.shape == (r, h, lp, S.DP) and o.shape == (r, seq, a) and lse.shape == (r, h, seq)
    got = S.attention_backward(g, x, gamma, wq, wo, stash, *args, prims=prims)
    for name, a_, b_ in zip(("dx", "dgamma", "dw_qkv", "dw_out"), got, ref):
        _close(a_, b_, name)


def test_rope_pairs_round_trip():
    """The kernels' RoPE (qkv_split) and its inverse (the backward's
    unrope) against ``ops/rope.py``: rotating then un-rotating is the
    identity, and the rotation is ``apply_rope``'s."""
    gen = torch.Generator().manual_seed(0)
    r, seq, h, d = 2, 9, 2, 24
    qkv = torch.randn(r, seq, 3 * h * d, generator=gen)
    cos, sin = AB._rope_tables(seq, d, 10000.0, True, torch.device("cpu"))
    q, k, v = (torch.empty(r, h, 64, S.DP) for _ in range(3))
    TorchPrims().qkv_split(qkv, cos, sin, q, k, v, r, seq, 64, h, d)
    want = apply_rope(qkv.view(r, seq, 3, h, d)[:, :, 0].transpose(1, 2))
    torch.testing.assert_close(q[:, :, :seq, :d], want, rtol=0, atol=1e-6)
    assert not q[:, :, seq:].any() and not q[..., d:].any()


# ----------------------------------------------------------------- gates

def _shipped():
    """(name, C, A, H, inner dims, k, groups) of every config whose blocks
    take the fused steps' flags (RMSGroupNorm, fused_ffn, flash_attention)."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))):
        name = os.path.basename(path)
        m = (C.load_speech_config(path).separator if name.startswith("speech")
             else C.load_model_config(path))
        dims = m.ffn_hidden_dim
        dims = tuple(dims) if isinstance(dims, (list, tuple)) else (dims,)
        out.append((name, m.emb_dim, m.attention_dim, m.n_heads, dims, m.conv1d_kernel,
                    m.num_groups, m.norm_type == "rmsgroupnorm"))
    return out


def test_fp32_gates_at_every_shipped_config():
    """Wherever the bf16 gates take a shipped config's steps, the fp32 gates
    do too, in eval and training (every speech config, base, medium, BS,
    low-memory); xlarge (C 256) and small (C 48) stay on the unfused route in
    both dtypes.  The layouts' bytes are pinned."""
    shipped = _shipped()
    assert len(shipped) == 10
    fused = set()
    for name, c, a, h, dims, k, groups, rms in shipped:
        for training in (False, True):
            for i in dims:
                bf = FB.supports_step(c, i, k, training, groups)
                assert FB.supports_step(c, i, k, training, groups, torch.float32) == bf, name
            bf = AB.supports_block(c, a, h, training)
            assert AB.supports_block(c, a, h, training, torch.float32) == bf, name
        if rms and FB.supports_step(c, dims[0], k, True, groups, torch.float32):
            fused.add(name)
    assert fused == {"musdb18.yaml", "musdb18_medium.yaml", "musdb18_bslocoformer.yaml",
                     "musdb18_lowmem.yaml", "speech_dns.yaml", "speech_whamr.yaml",
                     "speech_whamr_nope.yaml", "speech_wsj0_2mix.yaml"}
    assert S.launch_bytes(128, True) == {"gemm": 12800, "attn": 16384, "dkdv": 16896,
                                         "norm_bwd": 32768}
    assert S.launch_bytes(96) == {"gemm": 12800, "attn": 16384}
    assert not S.supports_ffn(256, 1024, 4, False)      # xlarge: the unfused route
    assert not S.supports_ffn(96, 386, 4, False)        # inner not whole float4s
    assert not S.supports_attention(96, 96, 2, False)   # head_dim 48 > 32


def test_fp32_model_takes_the_fused_steps(monkeypatch):
    """An fp32 model's blocks take the fused steps through the fp32 gates
    (the wrappers run their plain versions here); a bf16 model's the same."""
    from mss_tf_locoformer_tpu_torch.models import TFLocoformerSeparator
    cfg = C.SeparatorConfig(n_layers=1, emb_dim=32, num_groups=4, n_heads=2, attention_dim=32,
                            ffn_type=("swiglu_conv1d", "swiglu_conv1d"), ffn_hidden_dim=(64, 64),
                            flash_attention=True, fused_ffn=True)
    for training in (False, True):
        path = TFLocoformerSeparator(cfg).train(training).blocks[0].freq_path
        assert path.fused_steps(fp32=True) == ([True, True], True)
        assert path.fused_steps() == ([True, True], True)
    calls = spy(monkeypatch)
    model = TFLocoformerSeparator(cfg).eval()
    spec = torch.randn(1, 12, 65, dtype=torch.complex64)
    with torch.no_grad():
        model(spec)
    assert calls == {"fused_norm_ffn_residual": 4, "fused_attention_block": 2,
                     "swiglu_conv_deconv": 0, "flash_attention": 0}


def test_fp32_cuda_dispatch_is_its_own():
    """fp32 rows never reach the bf16 kernels: the wrappers send them to
    ``step_fp32`` (checked without a card by a stub), and an unsupported
    dtype raises."""
    import types
    seen = []
    stub = types.SimpleNamespace(
        ffn_forward=lambda *a, **k: seen.append("ffn") or "fp32",
        attention_forward=lambda *a, **k: seen.append("attn") or "fp32")
    x = torch.zeros(1, 4, 32)
    real = FB.step_fp32
    try:
        FB.step_fp32 = AB.step_fp32 = stub
        assert FB.ffn_step_forward(x, None, None, None, torch.zeros(8, 32, 4), None, 4, 1,
                                   1e-5) == "fp32"
        assert AB.attention_step_forward(x, None, torch.zeros(96, 32), None, 2, 1,
                                         1e-5) == "fp32"
    finally:
        FB.step_fp32 = AB.step_fp32 = real
    assert seen == ["ffn", "attn"]
    with pytest.raises(TypeError):
        FB._check(x.half(), None, torch.zeros(16, 32, 4), None, torch.zeros(8, 32, 4), None,
                  4, 1)


# ------------------------------------------------------- speech and train

def test_speech_loader_defaults_to_fp32_as_jax(tmp_path):
    """``load_speech_separator`` builds fp32 blocks by default, as the JAX
    loader builds its separator from ``module_kwargs()`` with the module's
    fp32 default precision."""
    import inspect

    from mss_tf_locoformer_tpu.core import config as JC
    from mss_tf_locoformer_tpu.core.precision import FP32 as JFP32
    from mss_tf_locoformer_tpu.infer import separate as jax_separate
    from mss_tf_locoformer_tpu.models.tflocoformer import TFLocoformerSeparator as JSep
    from mss_tf_locoformer_tpu_torch.core.precision import FP32
    from mss_tf_locoformer_tpu_torch.infer.separate import load_speech_separator
    from mss_tf_locoformer_tpu_torch.models import TFLocoformerSeparator
    path = os.path.join(REPO, "configs", "speech_wsj0_2mix.yaml")
    jcfg = JC.load_speech_config(path)
    assert "precision" not in jcfg.separator.module_kwargs()
    assert "precision" not in inspect.getsource(jax_separate.load_speech_separator)
    assert JSep.__dataclass_fields__["precision"].default == JFP32
    assert inspect.signature(load_speech_separator).parameters["precision"].default == FP32
    cfg = C.load_speech_config(path)
    ckpt = str(tmp_path / "m.pth")
    torch.save(TFLocoformerSeparator(cfg.separator).state_dict(), ckpt)
    model = load_speech_separator(ckpt, cfg, device="cpu")
    assert model.precision == FP32


def test_fp32_separator_matches_jax(rng):
    """The fp32 separator (the speech loader's default) against the JAX
    separator at fp32 on the same seeded weights (the JAX tree from
    ``jax.eval_shape(init)``), within the speech tests' 5e-4 / 1e-3."""
    from mss_tf_locoformer_tpu.core import config as JC
    from mss_tf_locoformer_tpu.models.tflocoformer import TFLocoformerSeparator as JSep
    from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
    from mss_tf_locoformer_tpu_torch.core.precision import FP32
    from mss_tf_locoformer_tpu_torch.models import TFLocoformerSeparator
    kw = dict(n_layers=1, emb_dim=32, num_groups=4, n_heads=2, attention_dim=32, num_spk=2,
              ffn_type=("swiglu_conv1d", "swiglu_conv1d"), ffn_hidden_dim=(64, 64),
              flash_attention=True, fused_ffn=True)
    jmod = JSep(**JC.SeparatorConfig(**kw).module_kwargs())
    spec = (0.3 * (rng.standard_normal((2, 24, 65)) + 1j * rng.standard_normal((2, 24, 65)))
            ).astype(np.complex64)
    prng = np.random.default_rng(3)

    def fill(path, leaf):
        z = prng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 1:
            return np.float32(path[-1].key != "bias") + 0.1 * z
        return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
    params = jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(jmod.init, jax.random.PRNGKey(0), spec))
    model = TFLocoformerSeparator(C.SeparatorConfig(**kw), FP32)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(spec)).numpy()
    want = np.asarray(jmod.apply(params, spec))
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def test_use_amp_false_step_matches_jax(rng, monkeypatch):
    """``use_amp: false`` through ``precision_from_amp`` (fp32 blocks, the
    fused structure) for one AdamW step against ``make_train_step``: the
    loss terms and the pre-clip grad_norm within 2e-4."""
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
    tiny = dict(n_layers=1, emb_dim=32, num_groups=4, n_heads=2, attention_dim=32,
                ffn_type=("swiglu_conv1d", "swiglu_conv1d"), ffn_hidden_dim=(64, 64),
                n_fft=256, hop_length=64, fused_ffn=True,
                flash_attention=True, fused_stft=True)
    raw = {"model": tiny, "loss": {"loss_type": "combined"},
           "training": dict(batch_size=2, gradient_clip=5.0, use_amp=False,
                            optimizer=dict(lr=1e-3, weight_decay=0.01))}
    cfg_t, cfg_j = C.config_from_dict(raw), JC.config_from_dict(raw)
    precision = precision_from_amp(cfg_t.training.use_amp, cfg_t.training.amp_dtype)
    assert precision == FP32
    jmodel = JaxMSS(cfg_j.model)
    mix = (0.3 * rng.standard_normal((2, 2000))).astype(np.float32)
    tgts = {s: (0.3 * rng.standard_normal((2, 2000))).astype(np.float32)
            for s in ("vocals", "drums", "bass", "other")}
    params = jmodel.init(jax.random.PRNGKey(0), mix[:1])
    sd = jax_params_to_state_dict(jax.device_get(params))
    model = build_model(cfg_t.model, precision)
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(model.parameters(), cfg_t.training)
    tx = JSt.make_optimizer(cfg_j.training)
    state = JSt.init_state(convert_state_dict({k: v.numpy() for k, v in sd.items()}), tx)
    _, ld_j = make_train_step(jmodel, cfg_j, tx)(state, mix, tgts, 1e-3, jax.random.PRNGKey(1))
    calls = spy(monkeypatch)
    ld_t = train_step(model, opt, torch.from_numpy(mix),
                      {k: torch.from_numpy(v) for k, v in tgts.items()}, 1e-3,
                      torch.Generator().manual_seed(0), cfg_t.loss, accum=1,
                      gradient_clip=cfg_t.training.gradient_clip)
    assert calls == {"fused_norm_ffn_residual": 4, "fused_attention_block": 2,
                     "swiglu_conv_deconv": 0, "flash_attention": 0}
    for k in ("total_loss", "grad_norm"):
        np.testing.assert_allclose(float(ld_t[k]), float(ld_j[k]), rtol=2e-4, err_msg=k)
