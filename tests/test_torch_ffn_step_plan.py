"""The Hopper FFN-step kernels' schedule (#2 forward, #5 backward) on the CPU.

``csrc/swiglu_block.cu``'s Hopper route (C 96 and 128) runs on the card
only, so its arithmetic is emulated here in plain torch, step for step,
from the weight stages the wrapper uploads (``wg_step_panels``: each stage
read back through the 128-byte swizzle as the kernels' descriptors address
it, the conv's as [C k][128 n] and [C n][128 k], the deconv's as [C n][64 k]
and [C k][64 n]):

* tiles of 128 conv positions over the rows laid end to end with their
  2(k-1) zero padding positions each (a tile packs the end of one row, its
  padding and the start of the next), each with its k-1 halo rows, and a
  short last tile; 128 - (k-1) outputs stored per tile;
* the norm prologue: per position and group in fp32, times gamma, one
  rounding to bf16 (zero rows outside [0, L));
* forward, per 64-channel chunk: the conv tap by tap; SwiGLU in fp32 with
  the inner mask, h rounded to bf16; the deconv by pairs of taps into fp32;
  bias, outer mask and residual, one rounding;
* backward, per 64-channel chunk: the conv again, dh from the dz tile (the
  cotangent through the outer mask, rounded to bf16), the SwiGLU backward
  in fp32, dyvg rounded to bf16, dxn from it; the norm's backward with the
  eps-on-rms quirk; dgamma and the deconv bias as sums over the stored
  positions;
* the row groups (the bf16 scratch within its cap), the scratch laid out
  as the same flat sequence of padded rows -- xn and dz zero-padded, dyvg
  and h zero at conv positions >= L + k - 1 -- and the weight-gradient GEMM's
  position splits (multiples of 64), its C side as taps of 128 channels
  (zeros past C), each an fp32 partial accumulated across groups and
  summed in split order.

The emulation is held against the JAX package's Pallas kernels
(``_blk_forward``, ``_blk_backward``) in interpret mode at tiny shapes and
dropout 0, and against the port's plain version at dropout 0.1 on a shape
whose row groups split."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.ops.pallas import swiglu_block as JFB
from mss_tf_locoformer_tpu_torch.ops import dropout as D
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF

MT = FB.WG_M          # conv positions per block
ROWS = FB.WG_ROWS     # staged rows per tile
ICH = FB.SICH         # inner channels per chunk (value and gate each)
CG = 128              # the GEMM's taps of 128 channels
GROUPS, EPS = 4, 1e-5
# The emulation rounds xn, h, dyvg, dz (and the bf16 rows) where the kernels
# do; the JAX kernels run in fp32 on the same bf16-representable inputs.
# Each rounding moves a term by at most one bf16 step (2^-8 of it), so
# outputs land within a few steps of the largest: 2e-2 of max|ref| (the
# card's STEP_TOL), and the weight gradients, sums over every position of
# independently rounded terms, within 2e-2 relative L2 (GRAD_REL_L2).  A
# wrong tap, stage, tile, group or split is O(1).
TOL = 2e-2


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _stage(flat, n, kc):
    """A stage as the kernel reads it: atoms ``[kc/64][n][64]`` with the
    chunk j of row n at j ^ (n % 8) -> ``[n][kc]``."""
    t = flat.reshape(kc // 64, n, 8, 8)
    rows = torch.arange(n)[:, None]
    src = torch.arange(8)[None, :] ^ (rows % 8)
    return t[:, rows, src].permute(1, 0, 2, 3).reshape(n, kc)


def _conv_stage(panels, ch, t, c):
    """Tap t's conv stage of chunk ch: ``[C][128]``, (c, value | gate)."""
    return _stage(panels[ch, t], c, 2 * ICH)


def _deconv_stage(panels, ch, t, k, c):
    """Tap t's half of its pair's deconv stage: ``[C][64]``, (c, i)."""
    return _stage(panels[ch, k + t // 2].reshape(2, c * ICH)[t % 2], c, ICH)


def _flat(t, k):
    """``t [R, L, C]`` as the kernels' flat sequence of padded rows: row r
    at flat positions r Lin .. r Lin + Lin - 1 (Lin = L + 2(k-1)), position
    j - (k-1) at j, zeros in the 2(k-1) padding positions; ``[R Lin, C]``."""
    r, seq, c = t.shape
    return F.pad(t, (0, 0, k - 1, k - 1)).reshape(r * (seq + 2 * (k - 1)), c)


def _tiles(r, seq, k):
    """(lt, tiles): 128 - (k-1) outputs a tile, tiles over flat outputs
    k-1 .. R Lin - 1 (FB.flat_tiles)."""
    lt = MT - (k - 1)
    return lt, FB.flat_tiles(r, seq, k)


def _staged(flat, tiles, lt):
    """Tile rows p < 136 of each tile: flat positions T lt + p (zeros past the
    end) -> ``[tiles, 136, C]``."""
    pad = F.pad(flat, (0, 0, 0, tiles * lt + ROWS))
    return pad[torch.arange(tiles)[:, None] * lt + torch.arange(ROWS)[None, :]]


def _conv_rows(tiles, lt, lin):
    """(row, conv position) of each tile row m < 128: two ``[tiles, 128]``."""
    q = torch.arange(tiles)[:, None] * lt + torch.arange(MT)[None, :]
    return q // lin, q % lin


def _inv_rms(x):
    """fp32 1 / (rms + eps) per position and group, ``[R, L, C]``."""
    r, seq, c = x.shape
    xg = x.reshape(r, seq, GROUPS, c // GROUPS)
    rms = xg.pow(2).sum(-1, keepdim=True).sqrt() / math.sqrt(c // GROUPS)
    return (1.0 / (rms + EPS)).expand_as(xg).reshape(r, seq, c)


def _inner_scale(drop, seed, row0, qrow, qpos, ch):
    """The inner site's keep scale at (absolute row, conv position, chunk
    channel): ``[tiles, 128, 64]``."""
    if drop == 0.0:
        return torch.ones(*qrow.shape, ICH)
    keep = D.reference_keep_mask(seed, D.SITE_FFN_INNER, (row0 + qrow)[..., None],
                                 qpos[..., None], (ch * ICH + torch.arange(ICH))[None, None],
                                 p=drop)
    return keep.float() * (1.0 / (1.0 - drop))


def _outer_scale(drop, seed, row0, x):
    if drop == 0.0:
        return torch.ones_like(x)
    return D.row_mask(seed, D.SITE_FFN_OUTER, x, row0, drop).float() * (1.0 / (1.0 - drop))


def _outputs(acc, r, seq, k):
    """Output rows l < lt of each tile, flat position T lt + l + k - 1, back
    to ``[R, L, ...]`` (padding positions dropped)."""
    tiles, _, *rest = acc.shape
    lt, lin = MT - (k - 1), seq + 2 * (k - 1)
    flat = torch.zeros(k - 1 + tiles * lt, *rest)
    flat[k - 1:] = acc[:, :lt].reshape(tiles * lt, *rest)
    return flat[:r * lin].reshape(r, lin, *rest)[:, k - 1:k - 1 + seq]


def emulate_forward(x, gamma, conv_w, conv_b, deconv_w, deconv_b, k, drop=0.0, seed=0,
                    row0=0):
    r, seq, c = x.shape
    lin = seq + 2 * (k - 1)
    lt, tiles = _tiles(r, seq, k)
    panels, bc = FB.wg_step_panels(conv_w, conv_b, deconv_w)
    panels = panels.float()
    xt = _staged(_flat(_bf16(x * _inv_rms(x) * gamma), k), tiles, lt)
    qrow, qpos = _conv_rows(tiles, lt, lin)
    z = torch.zeros(tiles, MT, c)
    for ch in range(panels.shape[0]):
        y = sum(xt[:, t:t + MT] @ _conv_stage(panels, ch, t, c) for t in range(k))
        v, gt = y[..., :ICH] + bc[ch, :ICH], y[..., ICH:] + bc[ch, ICH:]
        h = v * (gt / (1 + torch.exp(-gt))) * _inner_scale(drop, seed, row0, qrow, qpos, ch)
        h = F.pad(_bf16(h), (0, 0, 0, ROWS - MT))          # rows past the tile: zeros
        for t in range(k):
            z += h[:, k - 1 - t:k - 1 - t + MT] @ _deconv_stage(panels, ch, t, k, c).T
    zs = (_outputs(z, r, seq, k) + deconv_b) * _outer_scale(drop, seed, row0, x)
    return _bf16(x + zs)


def emulate_backward(g, x, gamma, conv_w, conv_b, deconv_w, k, drop=0.0, seed=0, row0=0,
                     scratch_cap=FB.SCRATCH_CAP):
    r, seq, c = x.shape
    inner = deconv_w.shape[0]
    lin, l1 = seq + 2 * (k - 1), seq + k - 1
    plan = FB.wg_step_plan(r, seq, c, inner, k, scratch_cap)
    ip, splits = plan["ip"], plan["splits"]
    panels, bc = FB.wg_step_panels(conv_w, conv_b, deconv_w)
    panels = panels.float()
    dx = torch.zeros(r, seq, c)
    dgamma, dbd = torch.zeros(c), torch.zeros(c)
    part = torch.zeros(splits, k * CG, 3 * ip)
    part_b = torch.zeros(splits, 2 * ip)
    for r0 in range(0, r, plan["rows"]):
        rows = min(plan["rows"], r - r0)
        lt, tiles = _tiles(rows, seq, k)
        xg, gg = x[r0:r0 + rows], g[r0:r0 + rows]
        inv = _inv_rms(xg)
        xn = _bf16(xg * inv * gamma)
        dz = _bf16(gg * _outer_scale(drop, seed, row0 + r0, xg))
        sxn, sdz = _flat(xn, k), _flat(dz, k)          # the scratch's xn and dz
        xt, zt = _staged(sxn, tiles, lt), _staged(sdz, tiles, lt)
        qrow, qpos = _conv_rows(tiles, lt, lin)
        live = ((qrow < rows) & (qpos < l1)).float()[..., None]
        dxn = torch.zeros(tiles, MT, c)
        sy = torch.zeros(tiles, MT, 2 * ip)
        sh = torch.zeros(tiles, MT, ip)
        for ch in range(panels.shape[0]):
            y = sum(xt[:, t:t + MT] @ _conv_stage(panels, ch, t, c) for t in range(k))
            dh = sum(zt[:, t:t + MT] @ _deconv_stage(panels, ch, t, k, c) for t in range(k))
            sc = _inner_scale(drop, seed, row0 + r0, qrow, qpos, ch) * live
            v, gt = y[..., :ICH] + bc[ch, :ICH], y[..., ICH:] + bc[ch, ICH:]
            sig = torch.sigmoid(gt)
            dhm = dh * sc
            dyvg = _bf16(torch.cat([dhm * gt * sig, dhm * v * sig * (1 + gt * (1 - sig))], -1))
            sy[..., 2 * ICH * ch:2 * ICH * (ch + 1)] = dyvg
            sh[..., ICH * ch:ICH * (ch + 1)] = _bf16(v * gt * sig * sc)
            dyvg = F.pad(dyvg, (0, 0, 0, ROWS - MT))
            for t in range(k):
                dxn += dyvg[:, k - 1 - t:k - 1 - t + MT] @ _conv_stage(panels, ch, t, c).T
        dxn = _outputs(dxn, rows, seq, k)
        # the norm's backward, the second term 0 at rms 0, and the residual
        dpg = c // GROUPS
        xgr = xg.reshape(rows, seq, GROUPS, dpg)
        rms = xgr.pow(2).sum(-1, keepdim=True).sqrt() / math.sqrt(dpg)
        tsum = (gamma.reshape(GROUPS, dpg) * dxn.reshape(rows, seq, GROUPS, dpg) * xgr).sum(
            -1, keepdim=True)
        ig = 1.0 / (rms + EPS)
        k2 = torch.where(rms > 0, tsum * ig * ig / (dpg * rms.clamp(min=1e-30)), 0.0)
        dxg = (gamma * dxn * inv).reshape(rows, seq, GROUPS, dpg) - xgr * k2
        dx[r0:r0 + rows] = _bf16(dxg.reshape(rows, seq, c) + gg)
        dgamma += (dxn * xg * inv).sum((0, 1))
        dbd += dz.sum((0, 1))
        # dyvg and h of flat position q: tile q // lt's row q % lt (the last
        # tile owns the group's end, fewer than 128 positions)
        n = rows * lin
        q = torch.arange(n)
        owner = (q // lt).clamp(max=tiles - 1)
        b_y, b_h = sy[owner, q - owner * lt], sh[owner, q - owner * lt]
        # the GEMM: flat positions of the group, A rows past them zero
        per = math.ceil(math.ceil(n / splits) / 64) * 64
        a_x = F.pad(sxn, (0, CG - c, 0, k))
        a_z = F.pad(sdz, (0, CG - c, 0, k))
        for s in range(splits):
            q0, q1 = s * per, min(n, (s + 1) * per)
            if q0 >= q1:
                continue
            for t in range(k):
                part[s, t * CG:(t + 1) * CG, :2 * ip] += a_x[q0 + t:q1 + t].T @ b_y[q0:q1]
                part[s, t * CG:(t + 1) * CG, 2 * ip:] += a_z[q0 + t:q1 + t].T @ b_h[q0:q1]
            part_b[s] += b_y[q0:q1].sum(0)
    out_w = sum(part[s] for s in range(splits)).reshape(k, CG, 3 * ip)
    out_b = sum(part_b[s] for s in range(splits))
    dcw, dcb, ddw = SF.wg_unpack_grads(out_w[:, :c], out_b, inner, ICH)
    return dx, dgamma, dcw, dcb, ddw, dbd


def _inputs(rng, r, seq, c, inner, k):
    b = (c * k) ** -0.5
    arrays = [rng.standard_normal((r, seq, c)), 1 + 0.1 * rng.standard_normal(c),
              rng.uniform(-b, b, (2 * inner, c, k)), rng.uniform(-b, b, 2 * inner),
              rng.uniform(-b, b, (inner, c, k)), rng.uniform(-b, b, c),
              rng.standard_normal((r, seq, c))]
    # bf16-representable rows and weights (the kernels take bf16), gamma fp32
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]
    return [t[1] if i == 1 else _bf16(a) for i, a in enumerate(t)]


def _close(got, want, what):
    want = torch.as_tensor(np.array(want), dtype=torch.float32)
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), (what, err, want.abs().max().item())


def _rel_l2(got, want):
    want = torch.as_tensor(np.array(want), dtype=torch.float32)
    return ((got - want).norm() / want.norm()).item()


def _jax(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return fn(*(jnp.asarray(a.numpy()) for a in args))


@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 150, 96, 64, 4), (1, 20, 128, 96, 8),
                                             (2, 9, 96, 40, 3), (6, 14, 128, 64, 4)])
def test_forward_schedule_matches_jax(rng, r, seq, c, inner, k):
    """Two rows of 150 (156 flat positions each: a tile across the rows'
    boundary, a short last tile), one short row at k 8 (a 7-row halo, I
    padded from 96 to 128), k 3 (a tap pair with one tap; I padded from 40
    to 64) and six rows of 14 packed into one tile."""
    x, gamma, *w, _ = _inputs(rng, r, seq, c, inner, k)
    got = emulate_forward(x, gamma, *w, k)
    want = _jax(lambda *a: JFB._blk_forward(*a, k, GROUPS, EPS, 0.0, None), x, gamma, *w)
    _close(got, want, "forward")


@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 150, 96, 64, 4), (2, 11, 128, 64, 8),
                                             (6, 14, 96, 64, 4)])
def test_backward_schedule_matches_jax(rng, r, seq, c, inner, k):
    x, gamma, *w, g = _inputs(rng, r, seq, c, inner, k)
    got = emulate_backward(g, x, gamma, *w[:3], k)
    want = _jax(lambda *a: JFB._blk_backward(*a[:6], k, GROUPS, EPS, 0.0, None, a[6]),
                x, gamma, *w, g)
    names = ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b")
    _close(got[0], want[0], "dx")
    for name, a, b in zip(names[1:], got[1:], want[1:]):
        assert _rel_l2(a, b) < TOL, name


@pytest.mark.parametrize("c", [96, 128])
def test_row_groups_and_dropout_match_the_plain_version(rng, c):
    """A scratch cap of two rows splits 5 rows into 3 groups (the last one
    short); the partials accumulate across them.  Dropout 0.1 replays the
    forward's masks from the absolute rows (row0 7)."""
    r, seq, inner, k, drop = 5, 40, 64, 4, 0.1
    x, gamma, *w, g = _inputs(rng, r, seq, c, inner, k)
    lin = seq + 2 * (k - 1)
    cap = 2 * lin * (3 * 64 + 2 * c) * 2
    plan = FB.wg_step_plan(r, seq, c, inner, k, cap)
    assert (plan["rows"], plan["groups"]) == (2, 3)
    got = emulate_backward(g, x, gamma, *w[:3], k, drop, 99, 7, scratch_cap=cap)
    whole = emulate_backward(g, x, gamma, *w[:3], k, drop, 99, 7)
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, *w)]
    out = FB.reference_norm_ffn_residual(*leaves, k, GROUPS, EPS, drop, 99, 7)
    ref = torch.autograd.grad(out, leaves, g)
    _close(got[0], ref[0], "dx")
    names = ("dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b")
    for name, a, b, c_ in zip(names, got[1:], ref[1:], whole[1:]):
        assert _rel_l2(a, b) < TOL, name
        # the groups change only the order of the fp32 sums
        assert _rel_l2(a, c_) < 1e-5, name
    assert torch.equal(got[0], whole[0])
    _close(emulate_forward(x, gamma, *w, k, drop, 99, 7), out.detach(), "forward, dropout")


@pytest.mark.parametrize("rows,seq", [(518, 1025), (2050, 259)])
def test_plan_bounds_the_scratch_at_the_base_training_shapes(rows, seq):
    """The base training micro-batch's FFN steps (freq and time paths): 2688
    bytes of scratch per padded position (xn, dz, dyvg, h in bf16), two row
    groups within 1 GiB each, the GEMM's blocks filling the 132 SMs four
    times over, and fp32 partials of tens of MiB."""
    c, inner, k = 96, 384, 4
    lin = seq + 2 * (k - 1)
    plan = FB.wg_step_plan(rows, seq, c, inner, k)
    assert plan["scratch_bytes"] == plan["rows"] * lin * 2688 <= FB.SCRATCH_CAP == 1 << 30
    assert plan["groups"] == 2 == math.ceil(rows / plan["rows"])
    assert plan["tiles"] * plan["splits"] >= 4 * 132
    assert plan["partial_bytes"] < 100 << 20


@pytest.mark.parametrize("c,k", [(96, 4), (128, 4), (96, 8), (128, 8), (96, 3)])
def test_stages_and_gate_bytes_follow_the_layouts(c, k):
    """Every stage is 256 C bytes (one ring slot): k conv stages and
    ceil(k/2) deconv pairs a chunk; the gate's bytes are the .cu layouts'
    (1 KB of slack, the 136-row tiles of 128-byte rows, the largest ring of
    at most 8 stages that fits 232,448 bytes, 8 bytes a barrier: 7 and 5
    forward stages, 5 and 3 in the dx kernel, at C 96 and 128), the same
    for every k, and the widths take the Hopper route."""
    gen = torch.Generator().manual_seed(0)
    w = [torch.randn(*s, generator=gen) for s in ((200, c, k), (200,), (100, c, k))]
    panels, bc = FB.wg_step_panels(*w)
    assert panels.shape == (2, k + -(-k // 2), 128 * c) and bc.shape == (2, 128)
    col = ROWS * 128
    for name, fixed in (("fwd", 1024 + 3 * col), ("dx", 1024 + 6 * col)):
        ns = max(n for n in range(2, 9) if fixed + n * 256 * c + (2 * n + 1) * 8 <= 232448)
        assert FB.wg_step_bytes(c)[name] == fixed + ns * 256 * c + (2 * ns + 1) * 8
    assert FB.wg_step_bytes(c)["dx"] - 1024 - 6 * col >= MT * (c + 4) * 4   # dxn rows fit
    assert FB.wg_step_bytes(c) == {96: {"fwd": 225400, "dx": 228440, "gemm": 197696},
                                   128: {"fwd": 217176, "dx": 203832, "gemm": 197696}}[c]
    assert FB.step_bytes(c, k) == FB.wg_step_bytes(c)["fwd"]
    assert FB.step_bytes(c, k, True) == max(FB.wg_step_bytes(c).values()) <= 232448
    assert FB.hopper_route(c) and FB.supports_step(c, 384, k, True)
    assert not FB.hopper_route(64) and FB.supports_step(64, 384, k, True)


def test_stage_layouts_read_back_the_weights(rng):
    """The conv stage of tap t read as [C][128] is (conv_w[value], conv_w
    [gate]) of the chunk; the deconv stage's half is deconv_w[i, c, t]; a
    tap past k (k 3: the second pair's second half) is zeros."""
    c, inner, k = 96, 100, 3
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k))]
    panels, bc = FB.wg_step_panels(*w)
    panels = panels.float()
    wc, wd = _bf16(w[0]), _bf16(w[2])
    for ch in range(2):
        i = torch.arange(ch * ICH, (ch + 1) * ICH)
        ok = i < inner
        for t in range(k):
            st = _conv_stage(panels, ch, t, c)
            torch.testing.assert_close(st[:, :ICH][:, ok], wc[i[ok], :, t].T)
            torch.testing.assert_close(st[:, ICH:][:, ok], wc[inner + i[ok], :, t].T)
            assert not st[:, :ICH][:, ~ok].any()
            torch.testing.assert_close(_deconv_stage(panels, ch, t, k, c)[:, ok], wd[i[ok], :, t].T)
        assert not _deconv_stage(panels, ch, k, k, c).any()
        torch.testing.assert_close(bc[ch, :ICH][ok], w[1][i[ok]])


def test_stage_cache_follows_the_weights():
    """The wrapper lays a step's weights out once and reuses the layout for
    the same tensors at the same versions; an in-place update (an optimizer
    step) or another bias tensor lays them out again."""
    gen = torch.Generator().manual_seed(1)
    w = [torch.nn.Parameter(torch.randn(*s, generator=gen))
         for s in ((128, 96, 4), (128,), (64, 96, 4))]
    first = FB._step_panels(*w)
    assert FB._step_panels(*w) is first
    with torch.no_grad():
        w[0].mul_(2.0)
    again = FB._step_panels(*w)
    assert again is not first
    torch.testing.assert_close(again[0], FB.wg_step_panels(*w)[0])
    assert FB._step_panels(w[0], w[1].detach().clone(), w[2]) is not again
