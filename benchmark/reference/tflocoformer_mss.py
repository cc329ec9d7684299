"""Plain PyTorch TF-Locoformer for music source separation, the reference
that decides ``correct`` for every TF-Locoformer MSS cell.

TF-Locoformer (Saijo et al., "TF-Locoformer: Transformer with Local
Modeling by Convolution for Speech Separation and Enhancement", arXiv:
2408.03440) as the public MSS training code lays it out
(chynggi/mss-tf-locoformer, ESPnet's ``TFLocoformerSeparator``):

  * STFT (periodic Hann, reflect centre pad, onesided) of the mono
    mixture; real and imaginary planes ``[B, 2, N, F]``;
  * encoder Conv2d(2 -> C, 3x3, pad 1) + GroupNorm(1);
  * ``n_layers`` blocks, each a Locoformer block over frequency (rows
    ``B*N``, sequence F) then one over time (rows ``B*F``, sequence N);
    a Locoformer block is FFN step, attention step, FFN step, each step
    ``x + f(RMSGroupNorm(x))``; the FFN is Conv1d(C -> 2I, k) with
    ``k - 1`` zeros on both sides, SwiGLU, ConvTranspose1d(I -> C, k),
    crop; attention is a bias-free QKV projection, interleaved-pair RoPE
    (theta 10000) on q and k, softmax(q k^T / sqrt(D)) v, a bias-free
    out-projection; the macaron FFNs are stored reversed (``ffn.1`` runs
    first) with no 1/2 factor, as the public code has them;
  * decoder ConvTranspose2d(C -> 2S, 3x3, pad 1), channel ``2s`` stem s's
    real part and ``2s + 1`` its imaginary part; iSTFT per stem.

Everything runs in float32 (TF32 off, which the caller sets).  ``rnd`` is
applied where the configuration's compute precision rounds (block inputs,
normed rows, weights, products, step outputs): the identity for the
reference itself, a rounding to a lower precision for the control.
Dropout in training mode uses the port's Philox masks (``philox.py``) with
the seeds drawn in the port's order: per block, the frequency path's three
steps then the time path's.

The steps run in blocks of rows (``ROW_ELEMS``) so that a forward at the
cells' sizes fits the card; under autograd each Locoformer block runs under
``torch.utils.checkpoint``, with its dropout masks made once beforehand.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import philox

SOURCES = ("vocals", "drums", "bass", "other")
ROW_ELEMS = 1 << 28      # fp32 elements of a step's largest intermediate per block of rows
SCORE_ELEMS = 1 << 28    # fp32 scores per group of (row, head) pairs

Round = Callable[[torch.Tensor], torch.Tensor]


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


# ------------------------------------------------------------------ weights


def _dims(m) -> List[int]:
    """The FFNs' inner widths as stored (``ffn.0`` runs after attention)."""
    hidden = m["ffn_hidden_dim"]
    return list(hidden)[::-1] if isinstance(hidden, (list, tuple)) else [hidden]


def param_specs(m) -> List[tuple]:
    """``(name, shape, init)`` of every parameter in the public checkpoint
    layout; ``init`` is a bound b of U(-b, b) (1 / sqrt(fan_in), torch's
    default for convolutions and linear layers), ``"one"`` or ``"zero"``."""
    if m.get("norm_type", "rmsgroupnorm") != "rmsgroupnorm":
        raise ValueError("the reference holds RMSGroupNorm blocks only")
    c, s, k, a = m["emb_dim"], m["n_sources"], m["conv1d_kernel"], m["attention_dim"]
    enc = 1 / math.sqrt(2 * 9)
    specs = [("conv.0.weight", (c, 2, 3, 3), enc), ("conv.0.bias", (c,), enc),
             ("conv.1.weight", (c,), "one"), ("conv.1.bias", (c,), "zero")]
    ffn = 1 / math.sqrt(c * k)
    for i in range(m["n_layers"]):
        for path in ("freq_path", "frame_path"):
            p = f"blocks.{i}.{path}."
            for j, inner in enumerate(_dims(m)):
                specs += [(p + f"ffn_norm.{j}.gamma", (c,), "one"),
                          (p + f"ffn.{j}.conv1d.weight", (2 * inner, c, k), ffn),
                          (p + f"ffn.{j}.conv1d.bias", (2 * inner,), ffn),
                          (p + f"ffn.{j}.deconv1d.weight", (inner, c, k), ffn),
                          (p + f"ffn.{j}.deconv1d.bias", (c,), ffn)]
            specs += [(p + "attn_norm.gamma", (c,), "one"),
                      (p + "attn.qkv.weight", (3 * a, c), 1 / math.sqrt(c)),
                      (p + "attn.aggregate_heads.0.weight", (c, a), 1 / math.sqrt(a))]
    dec = 1 / math.sqrt(2 * s * 9)
    specs += [("deconv.weight", (c, 2 * s, 3, 3), dec), ("deconv.bias", (2 * s,), dec)]
    return specs


def make_weights(m, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, fp32, from one uniform draw on ``device``."""
    specs = param_specs(m)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for (name, shape, init), n in zip(specs, sizes):
        if init == "one":
            out[name] = torch.ones(shape, device=device)
        elif init == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = ((flat[pos:pos + n] * 2 - 1) * init).view(shape)
        pos += n
    return out


# ------------------------------------------------------------------ pieces


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``[..., T]`` -> complex ``[..., F, N]``."""
    lead = x.shape[:-1]
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=x.device)
    spec = torch.stft(x.reshape(-1, x.shape[-1]).float(), n_fft, hop, window=win,
                      center=True, pad_mode="reflect", onesided=True, return_complex=True)
    return spec.reshape(lead + spec.shape[-2:])


def istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    lead = spec.shape[:-2]
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=spec.device)
    out = torch.istft(spec.reshape((-1,) + spec.shape[-2:]), n_fft, hop, window=win,
                      center=True, onesided=True, length=length)
    return out.reshape(lead + out.shape[-1:])


def rms_group_norm(x, gamma, groups: int, eps: float):
    g = x.unflatten(-1, (groups, x.shape[-1] // groups))
    rms = g.pow(2).sum(-1, keepdim=True).sqrt() * (g.shape[-1] ** -0.5)
    return (g / (rms + eps)).flatten(-2) * gamma


def rope(x: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Interleaved-pair rotary embedding of ``[..., L, D]``; angles in
    float64."""
    seq, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
    ang = np.outer(np.arange(seq, dtype=np.float64), inv)
    cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(x.device)
    sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(x.device)
    xf = x.unflatten(-1, (d // 2, 2))
    even, odd = xf[..., 0], xf[..., 1]
    return torch.stack([even * cos - odd * sin, odd * cos + even * sin], -1).flatten(-2)


def _drop(t, keep, p):
    return torch.where(keep, t * (1.0 / (1.0 - p)), torch.zeros((), device=t.device))


def ffn_step(x, w: Dict[str, torch.Tensor], pre: str, j: int, k: int, groups: int,
             eps: float, rnd: Round, p: float = 0.0, masks=None):
    """``x + FFN_j(RMSGroupNorm_j(x))`` on rows ``x [R, L, C]`` of the
    Locoformer block ``pre``; ``masks`` the inner ``[R, L+k-1, I]`` and
    outer ``[R, L, C]`` keep masks."""
    r, seq, _ = x.shape
    f = f"{pre}ffn.{j}."
    cw, cb = rnd(w[f + "conv1d.weight"]), rnd(w[f + "conv1d.bias"])
    dw, db = rnd(w[f + "deconv1d.weight"]), rnd(w[f + "deconv1d.bias"])
    inner = dw.shape[0]
    step = max(1, ROW_ELEMS // (2 * inner * (seq + k)))
    outs = []
    for r0 in range(0, r, step):
        xb = x[r0:r0 + step]
        n = xb.shape[0]
        xn = rnd(rms_group_norm(xb, w[f"{pre}ffn_norm.{j}.gamma"], groups, eps))
        y = rnd(F.conv1d(F.pad(xn.transpose(1, 2), (k - 1, k - 1)), cw, cb))
        h = rnd(y[:, :inner] * F.silu(y[:, inner:]))
        if masks is not None:
            h = _drop(h, masks[0][r0:r0 + n].transpose(1, 2), p)
        z = rnd(F.conv_transpose1d(h, dw, db)[:, :, k - 1:k - 1 + seq].transpose(1, 2))
        if masks is not None:
            z = _drop(z, masks[1][r0:r0 + n], p)
        outs.append(rnd(xb + z))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _core(q, k, v, keep, p):
    s = torch.einsum("...qd,...kd->...qk", q, k) / math.sqrt(q.shape[-1])
    a = torch.softmax(s, dim=-1)
    if keep is not None:
        a = _drop(a, keep, p)
    return torch.einsum("...qk,...kd->...qd", a, v)


def attention_step(x, w, pre: str, heads: int, groups: int, eps: float, rnd: Round,
                   p: float = 0.0, masks=None):
    """``x + MHSA(RMSGroupNorm(x))`` on rows ``x [R, L, C]``; ``masks`` the
    probability ``[R, H, L(query), L(key)]`` and projection ``[R, L, C]``
    keep masks."""
    r, seq, c = x.shape
    wq, wo = rnd(w[pre + "attn.qkv.weight"]), rnd(w[pre + "attn.aggregate_heads.0.weight"])
    a = wq.shape[0] // 3
    d = a // heads
    grad = torch.is_grad_enabled()
    step = max(1, ROW_ELEMS // (4 * seq * a))
    outs = []
    for r0 in range(0, r, step):
        xb = x[r0:r0 + step]
        n = xb.shape[0]
        xn = rnd(rms_group_norm(xb, w[pre + "attn_norm.gamma"], groups, eps))
        qkv = rnd(xn @ wq.T).reshape(n, seq, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, kk, v = rnd(rope(qkv[0])), rnd(rope(qkv[1])), qkv[2]
        qf, kf, vf = (t.reshape(n * heads, seq, d) for t in (q, kk, v))
        keep = None if masks is None else masks[0][r0:r0 + n].reshape(n * heads, seq, seq)
        g = max(1, SCORE_ELEMS // (seq * seq))
        o = []
        for f0 in range(0, n * heads, g):
            args = (qf[f0:f0 + g], kf[f0:f0 + g], vf[f0:f0 + g],
                    None if keep is None else keep[f0:f0 + g], p)
            o.append(checkpoint(_core, *args, use_reentrant=False) if grad else _core(*args))
        o = rnd(torch.cat(o)).reshape(n, heads, seq, d).transpose(1, 2).reshape(n, seq, a)
        z = rnd(o @ wo.T)
        if masks is not None:
            z = _drop(z, masks[1][r0:r0 + n], p)
        outs.append(rnd(xb + z))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


# ------------------------------------------------------------------ model


class Reference:
    """The model of one configuration's ``model`` section on the weights
    ``w`` (name -> fp32 tensor, the public layout)."""

    def __init__(self, m, w: Dict[str, torch.Tensor], rnd: Round = _same):
        self.m, self.w, self.rnd = m, w, rnd

    def _masks(self, seeds, rows: int, seq: int, training_p: float, dev):
        """The keep masks of one Locoformer block's three steps."""
        m = self.m
        c, k, h = m["emb_dim"], m["conv1d_kernel"], m["n_heads"]
        ids = torch.arange(rows, device=dev)
        dims = _dims(m)
        p = training_p

        def ffn(seed, inner):
            return (philox.keep(seed, philox.SITE_FFN_INNER, ids, seq + k - 1, 1, inner, p)[:, :, 0],
                    philox.keep(seed, philox.SITE_FFN_OUTER, ids, seq, 1, c, p)[:, :, 0])

        attn = (philox.keep(seeds[1], philox.SITE_ATTN_PROB, ids, h, seq, seq, p),
                philox.keep(seeds[1], philox.SITE_ATTN_PROJ, ids, seq, 1, c, p)[:, :, 0])
        return (ffn(seeds[0], dims[1] if len(dims) > 1 else dims[0]), attn,
                ffn(seeds[2], dims[0]))

    def _path(self, x, pre: str, masks, p: float):
        m, rnd = self.m, self.rnd
        b, s1, s2, c = x.shape
        rows = x.reshape(b * s1, s2, c)
        g, eps, k = m["num_groups"], m["eps"], m["conv1d_kernel"]
        nm = masks or (None, None, None)
        rows = ffn_step(rows, self.w, pre, 1, k, g, eps, rnd, p, nm[0])
        rows = attention_step(rows, self.w, pre, m["n_heads"], g, eps, rnd, p, nm[1])
        rows = ffn_step(rows, self.w, pre, 0, k, g, eps, rnd, p, nm[2])
        return rows.reshape(b, s1, s2, c)

    def __call__(self, mixture: torch.Tensor, generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0) -> Dict[str, torch.Tensor]:
        """``mixture [B, T]`` -> ``{stem: [B, T]}``; with ``dropout > 0``
        the step seeds come from ``generator`` in the port's order."""
        m, w, rnd = self.m, self.w, self.rnd
        b, length = mixture.shape
        spec = stft(mixture, m["n_fft"], m["hop_length"]).transpose(-1, -2)   # [B, N, F]
        n, f = spec.shape[1], spec.shape[2]
        x = torch.view_as_real(spec).permute(0, 3, 1, 2)                      # [B, 2, N, F]
        x = F.conv2d(x, w["conv.0.weight"], w["conv.0.bias"], padding=1)
        x = F.group_norm(x, 1, w["conv.1.weight"], w["conv.1.bias"], m["eps"])
        x = rnd(x.permute(0, 2, 3, 1).contiguous())                           # [B, N, F, C]
        grad = torch.is_grad_enabled()
        for i in range(m["n_layers"]):
            for path, rows, seq in (("freq_path", b * n, f), ("frame_path", b * f, n)):
                masks = None
                if dropout > 0.0:
                    seeds = [philox.draw_seed(generator) for _ in range(3)]
                    masks = self._masks(seeds, rows, seq, dropout, x.device)
                pre = f"blocks.{i}.{path}."
                if grad:
                    x = checkpoint(self._path, x, pre, masks, dropout, use_reentrant=False)
                else:
                    x = self._path(x, pre, masks, dropout)
                x = x.transpose(1, 2).contiguous()      # freq path [B, N, F] <-> time path [B, F, N]
        x = F.conv_transpose2d(x.permute(0, 3, 1, 2), w["deconv.weight"], w["deconv.bias"],
                               padding=1)                                      # [B, 2S, N, F]
        s = m["n_sources"]
        x = x.reshape(b, s, 2, n, f)
        spec_out = torch.complex(x[:, :, 0], x[:, :, 1]).transpose(-1, -2)   # [B, S, F, N]
        audio = istft(spec_out, m["n_fft"], m["hop_length"], length)
        return {SOURCES[j]: audio[:, j] for j in range(s)}


# ------------------------------------------------------------------ training


def _flat(x):
    return x.reshape(-1, x.shape[-1]) if x.dim() > 2 else x


def si_sdr(est, tgt, eps):
    est, tgt = _flat(est), _flat(tgt)
    est = est - est.mean(-1, keepdim=True)
    tgt = tgt - tgt.mean(-1, keepdim=True)
    proj = (est * tgt).sum(-1, keepdim=True) / ((tgt * tgt).sum(-1, keepdim=True) + eps) * tgt
    return 10 * torch.log10(((proj * proj).sum(-1) + eps) / ((est - proj).square().sum(-1) + eps))


def loss(pred: Dict[str, torch.Tensor], tgt: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """The combined MSS loss of the public code: per stem, -SI-SDR, L1 and
    the L1 of log1p STFT magnitudes (n_fft 2048, hop 1024), weighted into
    ``total_loss``; each term unweighted under ``<stem>_si_sdr``,
    ``<stem>_l1`` and ``<stem>_spectral``, as the port's loss dict."""
    eps = cfg.get("eps", 1e-8)
    n_fft, hop = cfg.get("spectral_n_fft", 2048), cfg.get("spectral_hop_length", 1024)
    if cfg.get("loss_type", "combined") != "combined":
        raise ValueError("the reference holds the combined loss only")
    out, total = {}, 0.0
    for name, p in pred.items():
        t = tgt[name]
        out[name + "_si_sdr"] = -si_sdr(p, t, eps).mean()
        out[name + "_l1"] = (p - t).abs().mean()
        total = total + (cfg.get("si_sdr_weight", 1.0) * out[name + "_si_sdr"]
                         + cfg.get("l1_weight", 0.1) * out[name + "_l1"])
        if cfg.get("spectral_weight", 0.1) > 0:
            sp = torch.log1p(stft(_flat(p), n_fft, hop).abs())
            st = torch.log1p(stft(_flat(t), n_fft, hop).abs())
            out[name + "_spectral"] = (sp - st).abs().mean()
            total = total + cfg.get("spectral_weight", 0.1) * out[name + "_spectral"]
    out["total_loss"] = total
    return out


class TrainReference:
    """Optimizer steps of the reference: micro-batches forward and backward
    (each loss over ``accum``), clipping by global norm (no epsilon), AdamW
    (decoupled weight decay, bias-corrected moments)."""

    def __init__(self, config, w: Dict[str, torch.Tensor], gen_seed: int,
                 rnd: Round = _same):
        self.m, self.t, self.loss_cfg = config["model"], config["training"], config.get("loss", {})
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
        self.model = Reference(self.m, self.params, rnd)
        self.generator = torch.Generator().manual_seed(gen_seed)
        self.m1 = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.m2 = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0

    def step(self, mixture, targets: Dict[str, torch.Tensor], lr: float):
        """One optimizer step; returns ``({term: value}, {name: clipped
        gradient})``, the loss terms (``loss``'s keys) averaged over the
        micro-batches."""
        accum = self.t.get("gradient_accumulation_steps", 1)
        micro = mixture.shape[0] // accum
        for p in self.params.values():
            p.grad = None
        terms: Dict[str, float] = {}
        for i in range(accum):
            sl = slice(i * micro, (i + 1) * micro)
            out = self.model(mixture[sl], self.generator, self.m.get("dropout", 0.0))
            values = loss(out, {k: v[sl] for k, v in targets.items()}, self.loss_cfg)
            (values["total_loss"] / accum).backward()
            for k, v in values.items():
                terms[k] = terms.get(k, 0.0) + float(v.detach()) / accum
        grads = {k: p.grad for k, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        clip = self.t.get("gradient_clip", 5.0)
        if norm > clip:
            for g in grads.values():
                g.mul_(clip / norm)
        opt = self.t.get("optimizer", {})
        b1, b2 = opt.get("betas", (0.9, 0.999))
        eps, wd = opt.get("eps", 1e-8), opt.get("weight_decay", 0.01)
        self.count += 1
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                p.mul_(1 - lr * wd)
                self.m1[k].mul_(b1).add_(g, alpha=1 - b1)
                self.m2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.addcdiv_(self.m1[k], (self.m2[k] / c2).sqrt().add_(eps), value=-lr / c1)
        return terms, {k: g.detach().clone() for k, g in grads.items()}
