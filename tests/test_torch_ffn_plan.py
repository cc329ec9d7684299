"""The Hopper FFN-core kernels' schedule (#8 forward, #9 backward) on the CPU.

``csrc/swiglu_ffn.cu``'s Hopper route (C 128 and 256) runs on the card only,
so its arithmetic is emulated here in plain torch, step for step, from the
weight stages the wrapper uploads (``wg_forward_panels``,
``wg_backward_panels``: each stage read back through the 128-byte swizzle
exactly as the kernels' descriptors address it):

* tiles of 128 conv positions, each with its k-1 halo rows (zeros outside
  the row) and a ragged last tile; 128 - (k-1) outputs stored per tile;
* forward, per 64-channel chunk: the conv tap by tap, each tap in C/64
  stages; SwiGLU in fp32 with the inner mask, h rounded to bf16; the
  deconv tap by tap in C/128 stages;
* backward, per 32-channel chunk: the conv in two halves of C, the
  deconv's adjoint dh, the SwiGLU backward in fp32, dyvg rounded to bf16,
  dx from it;
* the backward's row groups (the bf16 scratch within its cap), the scratch
  laid out with x's row stride Lin and zeros at conv positions >= l1, so
  that ``sum_q x[q + t]^T dyvg[q]`` over flat q is the per-row sum;
* the weight-gradient GEMM's position splits (multiples of 64 positions),
  each an fp32 partial accumulated across groups, summed in split order;
  the conv bias's gradient from the column sums of the bf16 dyvg.

The emulation is held against the JAX package's Pallas kernels
(``_forward``, ``_backward_pallas``) in interpret mode at tiny shapes, as
tests/test_torch_unfused*.py run them on the CPU, and against the port's
plain version at a shape whose row groups split."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.ops.pallas import swiglu_ffn as JFFN
from mss_tf_locoformer_tpu_torch.ops import dropout as D
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF

MT = 128          # csrc/swiglu_ffn.cu's wgk::MT (conv positions per block)
ICH = SF.ICH
# The emulation rounds h, dyvg (and the bf16 rows) where the kernels do; the
# JAX kernels run in fp32 on the same bf16-representable inputs.  Each
# rounding moves a term by at most one bf16 step (2^-8 of it), so outputs
# land within a few steps of the largest: 2e-2 of max|ref| (the card's
# STEP_TOL), and the weight gradients, sums over every position of
# independently rounded terms, within 2e-2 relative L2 (GRAD_REL_L2).  A
# wrong tap, stage, tile, group or split is O(1).
TOL = 2e-2


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _stage(flat, n, kc):
    """A weight stage as the kernel reads it: atoms ``[kc/64][n][64]`` with
    the chunk j of row n at j ^ (n % 8) -> ``[n][kc]`` (row n, column k)."""
    t = flat.reshape(kc // 64, n, 8, 8)
    rows = torch.arange(n)[:, None]
    src = torch.arange(8)[None, :] ^ (rows % 8)
    return t[:, rows, src].permute(1, 0, 2, 3).reshape(n, kc)


def _tiles(x, k):
    """``([R, tiles, 128 + 8, C], lt, tiles)``: each tile's rows from conv
    position p0 = j0 - (k-1) on (x rows outside [0, Lin) zero), lt = 128 -
    (k-1) outputs stored per tile."""
    r, lin, c = x.shape
    lt = MT - (k - 1)
    tiles = -(-lin // lt)
    pad = torch.zeros(r, (k - 1) + tiles * lt + MT + 8, c)
    pad[:, k - 1:k - 1 + lin] = x
    idx = torch.arange(tiles)[:, None] * lt + torch.arange(MT + 8)[None, :]
    return pad[:, idx], lt, tiles


def _positions(tiles, lt, k):
    """Conv position of each tile row m < 128: ``[tiles, 128]``."""
    return torch.arange(tiles)[:, None] * lt - (k - 1) + torch.arange(MT)[None, :]


def _mask(p, lin, k, drop, seed, row0, rows, ch, ich=ICH):
    """The inner site's keep scale at (absolute row, position, chunk
    channel) for the tile rows: ``[R, tiles, 128, ich]``, 0 off [0, l1)."""
    live = ((p >= 0) & (p < lin - k + 1)).float()[None, :, :, None]
    if drop == 0.0:
        return live.expand(rows, *p.shape, ich)
    keep = D.reference_keep_mask(seed, D.SITE_FFN_INNER,
                                 (row0 + torch.arange(rows))[:, None, None, None],
                                 p.clamp(min=0)[None, :, :, None],
                                 (ch * ich + torch.arange(ich))[None, None, None], p=drop)
    return live * keep.float() / (1.0 - drop)


def _store(acc, lt, lin):
    """The stored outputs of each tile (rows l < lt) as ``[R, Lin, C]``."""
    r, tiles, _, c = acc.shape
    return acc[:, :, :lt].reshape(r, tiles * lt, c)[:, :lin]


def emulate_forward(x, conv_w, conv_b, deconv_w, deconv_b, k, drop=0.0, seed=0, row0=0):
    r, lin, c = x.shape
    fich = SF.FICH
    panels, bc = SF.wg_forward_panels(conv_w, conv_b, deconv_w)
    panels = panels.float()
    xt, lt, tiles = _tiles(_bf16(x), k)
    p = _positions(tiles, lt, k)
    z = torch.zeros(r, tiles, MT, c)
    for ch in range(panels.shape[0]):
        st = panels[ch]
        y = torch.zeros(r, tiles, MT, 2 * fich)
        for t in range(k):
            for kq in range(c // 64):
                b = _stage(st[t * (c // 64) + kq], 2 * fich, 64)
                y += xt[:, :, t:t + MT, kq * 64:(kq + 1) * 64] @ b.T
        v, gt = y[..., :fich] + bc[ch, :fich], y[..., fich:] + bc[ch, fich:]
        h = _bf16(v * (gt / (1 + torch.exp(-gt)))
                  * _mask(p, lin, k, drop, seed, row0, r, ch, fich))
        hp = F.pad(h, (0, 0, 0, 8))                  # rows past the tile: zeros
        for t in range(k):
            for nq in range(c // 128):
                b = _stage(st[k * (c // 64) + t * (c // 128) + nq], 128, 64)
                z[..., nq * 128:(nq + 1) * 128] += hp[:, :, k - 1 - t:k - 1 - t + MT] @ b.T
    return _bf16(_store(z + deconv_b.float(), lt, lin))


def emulate_dx(x, g, conv_w, conv_b, deconv_w, k, drop, seed, row0):
    """The dx kernel on one row group: ``(dx, dyvg [R, Lin, 2 Ip], h [R, Lin,
    Ip])``, the scratch in bf16, chunk-major (32 value, 32 gate)."""
    r, lin, c = x.shape
    panels, bc = SF.wg_backward_panels(conv_w, conv_b, deconv_w)
    panels = panels.float()
    nch = panels.shape[0]
    xt, lt, tiles = _tiles(_bf16(x), k)
    gt_rows, _, _ = _tiles(_bf16(g), k)
    p = _positions(tiles, lt, k)
    acc = torch.zeros(r, tiles, MT, c)
    sy = torch.zeros(r, tiles, MT, 2 * nch * ICH)
    sh = torch.zeros(r, tiles, MT, nch * ICH)
    for ch in range(nch):
        st = panels[ch]
        y = torch.zeros(r, tiles, MT, 2 * ICH)
        dh = torch.zeros(r, tiles, MT, ICH)
        for t in range(k):
            for half in range(2):
                b = _stage(st[3 * t + half], 2 * ICH, c // 2)
                y += xt[:, :, t:t + MT, half * c // 2:(half + 1) * c // 2] @ b.T
            dh += gt_rows[:, :, t:t + MT] @ _stage(st[3 * t + 2], ICH, c).T
        sc = _mask(p, lin, k, drop, seed, row0, r, ch)
        v, gt = y[..., :ICH] + bc[ch, :ICH], y[..., ICH:] + bc[ch, ICH:]
        sig = 1 / (1 + torch.exp(-gt))
        dhm = dh * sc
        dyvg = _bf16(torch.cat([dhm * gt * sig, dhm * v * sig * (1 + gt * (1 - sig))], -1))
        sy[..., ch * 2 * ICH:(ch + 1) * 2 * ICH] = dyvg
        sh[..., ch * ICH:(ch + 1) * ICH] = _bf16(v * gt * sig * sc)
        yp = F.pad(dyvg, (0, 0, 0, 8))
        for t in range(k):
            for nh in range(2):
                b = _stage(st[3 * k + 2 * t + nh], c // 2, 2 * ICH)
                acc[..., nh * c // 2:(nh + 1) * c // 2] += yp[:, :, k - 1 - t:k - 1 - t + MT] @ b.T
    # each tile owns the conv positions of its stored outputs: [j0, j0 + lt)
    own = lambda a: a[:, :, k - 1:].reshape(r, tiles * lt, a.shape[-1])[:, :lin]
    return _bf16(_store(acc, lt, lin)), own(sy), own(sh)


def emulate_backward(g, x, conv_w, conv_b, deconv_w, k, drop=0.0, seed=0, row0=0,
                     scratch_cap=SF.SCRATCH_CAP):
    r, lin, c = x.shape
    inner = deconv_w.shape[0]
    plan = SF.wg_backward_plan(r, lin, c, inner, k, scratch_cap)
    ip, group, splits = plan["ip"], plan["rows"], plan["splits"]
    xf = _bf16(x).reshape(r * lin, c)
    gf = _bf16(g).reshape(r * lin, c)
    xf, gf = (F.pad(a, (0, 0, 0, 64 + k)) for a in (xf, gf))   # past the tensor: zeros
    part = torch.zeros(splits, k, c, 3 * ip)
    part_b = torch.zeros(splits, 2 * ip)
    dx = torch.empty(r, lin, c)
    for r0 in range(0, r, group):
        rows = min(group, r - r0)
        dxg, sy, sh = emulate_dx(x[r0:r0 + rows], g[r0:r0 + rows], conv_w, conv_b, deconv_w,
                                 k, drop, seed, row0 + r0)
        dx[r0:r0 + rows] = dxg
        q = rows * lin
        sy, sh = sy.reshape(q, 2 * ip), sh.reshape(q, ip)
        per = -(-(-(-q // splits)) // 64) * 64
        for s in range(splits):
            q0, q1 = min(q, s * per), min(q, (s + 1) * per)
            a0 = r0 * lin + q0
            for t in range(k):
                part[s, t, :, :2 * ip] += xf[a0 + t:a0 + t + q1 - q0].T @ sy[q0:q1]
                part[s, t, :, 2 * ip:] += gf[a0 + t:a0 + t + q1 - q0].T @ sh[q0:q1]
            part_b[s] += sy[q0:q1].sum(0)
    out_w, out_b = part[0].clone(), part_b[0].clone()
    for s in range(1, splits):          # the reduction's fixed order
        out_w += part[s]
        out_b += part_b[s]
    dcw, dcb, ddw = SF.wg_unpack_grads(out_w, out_b, inner)
    return dx, dcw, dcb, ddw, _bf16(g).sum((0, 1))


def _inputs(rng, r, seq, c, inner, k):
    lin = seq + 2 * (k - 1)
    x = np.zeros((r, lin, c), np.float32)
    x[:, k - 1:k - 1 + seq] = rng.standard_normal((r, seq, c))
    b = (c * k) ** -0.5
    w = [rng.uniform(-b, b, s).astype(np.float32)
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    g = rng.standard_normal((r, lin, c)).astype(np.float32)
    # bf16-representable inputs: the kernels take bf16 rows and weights
    to = lambda a: _bf16(torch.from_numpy(a))
    return to(x), [to(a) for a in w], to(g)


def _close(got, want, what):
    want = torch.tensor(np.array(want), dtype=torch.float32)
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), (what, err, want.abs().max().item())


def _rel_l2(got, want):
    want = torch.tensor(np.array(want), dtype=torch.float32)
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 150, 128, 40, 4), (1, 20, 256, 64, 3),
                                             (2, 9, 128, 96, 8)])
def test_forward_schedule_matches_jax(rng, r, seq, c, inner, k):
    """Ragged tails (150 + 6 rows: two tiles of 125), one short tile, k 3
    (a tap pair with one tap) and k 8 (a 7-row halo); I padded to 64."""
    x, w, _ = _inputs(rng, r, seq, c, inner, k)
    got = emulate_forward(x, *w, k)
    with pltpu.force_tpu_interpret_mode():
        want = JFFN._forward(*(jnp.asarray(a.numpy()) for a in (x, *w)), k)
    _close(got, want, "forward")


@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 150, 128, 40, 4), (3, 11, 256, 64, 3)])
def test_backward_schedule_matches_jax(rng, r, seq, c, inner, k):
    x, w, g = _inputs(rng, r, seq, c, inner, k)
    got = emulate_backward(g, x, *w[:3], k)
    with pltpu.force_tpu_interpret_mode():
        want = JFFN._backward_pallas(*(jnp.asarray(a.numpy()) for a in (x, *w)), k,
                                     jnp.asarray(g.numpy()))
    names = ("dx", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b")
    _close(got[0], want[0], "dx")
    for name, a, b in zip(names[1:], got[1:], want[1:]):
        assert _rel_l2(a, b) < TOL, name


@pytest.mark.parametrize("drop", [0.0, 0.25])
def test_backward_row_groups_match_the_plain_version(rng, drop):
    """A scratch cap of two rows splits 5 rows into 3 groups (the last one
    short); the partials accumulate across them.  Dropout replays the
    forward's mask from the absolute rows (row0 7)."""
    r, seq, c, inner, k = 5, 40, 128, 64, 4
    x, w, g = _inputs(rng, r, seq, c, inner, k)
    lin = x.shape[1]
    cap = 2 * lin * 3 * 64 * 2
    plan = SF.wg_backward_plan(r, lin, c, inner, k, cap)
    assert (plan["rows"], plan["groups"]) == (2, 3)
    got = emulate_backward(g, x, *w[:3], k, drop, 99, 7, scratch_cap=cap)
    whole = emulate_backward(g, x, *w[:3], k, drop, 99, 7)
    leaves = [t.clone().requires_grad_(True) for t in (x, *w)]
    out = SF.reference_swiglu_conv_deconv(*leaves, k, drop, 99, 7)
    ref = torch.autograd.grad(out, leaves, g)
    _close(got[0], ref[0], "dx")
    for name, a, b, c_ in zip(("dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b"), got[1:],
                              ref[1:], whole[1:]):
        assert _rel_l2(a, b) < TOL, name
        # the groups change only the order of the fp32 sums
        assert _rel_l2(a, c_) < 1e-5, name
    emu = emulate_forward(x, *w, k, drop, 99, 7)
    _close(emu, out.detach(), "forward with dropout")


def test_scratch_layout_pairs_positions_within_rows(rng):
    """With zeros at conv positions >= l1, the flat sum over q of x[q + t]^T
    dyvg[q] (reading into the next row at the end of a row) equals the sum
    of the per-row products over each row's conv positions."""
    r, lin, c, n, k = 3, 13, 4, 5, 4
    l1 = lin - k + 1
    x = torch.from_numpy(rng.standard_normal((r, lin, c)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((r, lin, n)).astype(np.float32))
    dy[:, l1:] = 0
    xf = F.pad(x.reshape(r * lin, c), (0, 0, 0, k))
    for t in range(k):
        flat = xf[t:t + r * lin].T @ dy.reshape(r * lin, n)
        per_row = sum(x[i, t:t + l1].T @ dy[i, :l1] for i in range(r))
        torch.testing.assert_close(flat, per_row)


@pytest.mark.parametrize("rows,seq", [(646, 2049), (2049, 646)])
def test_plan_bounds_the_scratch_at_the_xlarge_training_shapes(rows, seq):
    """The xlarge training micro-batch's FFN cores (freq and time paths): the
    scratch within 1 GiB, the GEMM's blocks fill the 132 SMs four times
    over, and the fp32 partials stay small."""
    c, inner, k = 256, 1024, 4
    lin = seq + 2 * (k - 1)
    plan = SF.wg_backward_plan(rows, lin, c, inner, k)
    assert plan["scratch_bytes"] <= SF.SCRATCH_CAP == 1 << 30
    assert plan["rows"] == SF.SCRATCH_CAP // (lin * 3 * inner * 2)
    assert plan["groups"] == math.ceil(rows / plan["rows"])
    assert plan["tiles"] * plan["splits"] >= 4 * 132
    assert plan["partial_bytes"] < 100 << 20


def test_stages_fit_their_ring():
    """Every stage fills one ring slot (16 KB forward, 64 C bytes in the
    dx kernel); the layouts' bytes are the .cu ones, within the card's
    shared memory."""
    gen = torch.Generator().manual_seed(0)
    for c, k in ((128, 4), (256, 3), (256, 8)):
        w = [torch.randn(*s, generator=gen) for s in ((160, c, k), (160,), (80, c, k))]
        fwd, _ = SF.wg_forward_panels(*w)
        bwd, _ = SF.wg_backward_panels(*w)
        assert fwd.shape == (2, k * (c // 64 + c // 128), 8192)
        assert bwd.shape == (4, 5 * k, 32 * c)
    assert SF.wg_bytes(256) == {"fwd": 220280, "dx": 223304, "gemm": 197696}
    assert max(max(SF.wg_bytes(c).values()) for c in SF.WG_WIDTHS) <= 232448
