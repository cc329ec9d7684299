"""The attention-step kernels' schedule (#3 forward, #4 backward) on the CPU.

``csrc/attention_block.cu`` runs on the card only, so its arithmetic is
emulated here in plain torch, step for step:

* forward: the fp32 RMSGroupNorm rounded once to bf16; q, k, v from the QKV
  product rounded to bf16; q rotated in fp32, times ``scale * log2(e)`` and
  rounded once (q'), k rotated and rounded; per (row, head) and 16-query
  tile, 64-key tiles while they are full, then 16-key tiles with keys >= L
  masked; P taken with the old running max (0 at first), which moves to the
  row's max only when a row's tile sum of the bf16 P passes 2^16 or, in the
  first tile, falls below 1 (the lazy rescale; the tile's 16 rows
  together); the row sums of the undropped bf16 P; the probability mask on
  P before P V; o = O / l times 1/(1-p), rounded; the log-sum-exp in log2
  units; the out-projection of every head's o, its mask, the residual;
* backward: dproj = g * mask, dO = dproj Wo^T rounded, delta = rowsum(dO o);
  the dq pass (per 16 keys of 64-key tiles: P = ex2(S - lse), keys >= L
  dropped, dS = P (mask dP / (1-p) - delta) rounded, dQ += dS K) and the
  dk/dv pass (per 16 queries of 64-query tiles: P^T, dV += (mask P)^T dO,
  dS^T, dK += dS^T Q', all rounded as the kernels round their operands);
  dq = R^T(dQ / sqrt(D)), dk = R^T(ln 2 dK), dv = dV / (1-p); the QKV
  product's and the norm's backward, the weight gradients.

The emulation is held against the JAX package's ``fused_attention_block``
(forward ``_attn_forward``, backward ``_attn_backward_pallas`` through its
``custom_vjp``) in interpret mode at tiny shapes, one JAX run per shape
shared by the forward and backward tests, and at dropout 0.1 against the
port's plain version (the TPU's mask bits are not the port's)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.ops.pallas import attention_block as JAB
from mss_tf_locoformer_tpu_torch.ops import dropout as DR
from mss_tf_locoformer_tpu_torch.ops.cuda import SMEM_OPTIN
from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.rope import rope_angles

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
LAZY_LIMIT = 65536.0   # csrc/flash_tile.cuh's LAZY_LIMIT
DP = 32                # head dims padded for the MMA depth
GROUPS, EPS = 4, 1e-5
# The emulation rounds q', k, v, o, P, dO and dS to bf16 as the kernels do;
# the JAX kernels and the plain version run in fp32 on the same
# bf16-representable inputs.  Each rounding moves a term by at most one bf16
# step (2^-8 of it), so outputs and gradients land within a few steps of the
# largest: 2e-2 of max|ref| (the card's STEP_TOL, as the flash plan).  A
# wrong mask, tile, rescale or sum is O(1).
TOL = 2e-2


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _rot(x, cos, sin, inverse=False):
    """The kernels' pair rotation in fp32 (R, or R^T with ``inverse``)."""
    e, o = x[..., 0::2], x[..., 1::2]
    s = -sin if inverse else sin
    out = torch.empty_like(x)
    out[..., 0::2] = e * cos - o * s
    out[..., 1::2] = o * cos + e * s
    return out


def _pad_rows(x, n):
    return torch.cat([x, x.new_zeros(n - x.shape[0], *x.shape[1:])])


def _key_tiles(seq):
    """(first key, keys) of the forward's tiles: 64 while full, then 16."""
    tiles, j0 = [], 0
    while j0 + 64 <= seq:
        tiles.append((j0, 64))
        j0 += 64
    while j0 < seq:
        tiles.append((j0, 16))
        j0 += 16
    return tiles


def core_forward(qp, kp, v, keep=None, mul=1.0, stats=None):
    """#3's core on one (row, head): q', k', v ``[L, 32]`` (bf16 values),
    ``keep [L(query), L(key)]`` or None.  ``(o [L, 32] rounded, lse [L],
    log2 units)``."""
    seq = qp.shape[0]
    lp = -(-seq // 16) * 16
    qp, kp, v = (_pad_rows(t, lp) for t in (qp, kp, v))
    if keep is not None:
        keep = torch.nn.functional.pad(keep, (0, lp - seq, 0, lp - seq), value=True)
    out, lse = torch.empty(lp, DP), torch.empty(lp)
    for t in range(lp // 16):
        rows = slice(16 * t, 16 * t + 16)
        m, l, acc = torch.zeros(16), torch.zeros(16), torch.zeros(16, DP)
        for i, (j0, nk) in enumerate(_key_tiles(seq)):
            keys = torch.arange(j0, j0 + nk)
            s = qp[rows] @ kp[keys].T - m[:, None]        # the MMA started at -m
            s[:, keys >= seq] = -math.inf
            p = _bf16(torch.exp2(s))                      # with the old m (0 at first)
            rs = p.sum(1)
            bad = ~(rs <= LAZY_LIMIT)
            if i == 0:
                bad |= ~(rs >= 1.0)
            if bool(bad.any()):                           # the tile's 16 rows together
                if stats is not None and i > 0:
                    stats["rescales"] += 1
                mx = s.max(1).values
                dm = mx if i == 0 else mx.clamp(min=0.0)
                m = m + dm
                a = torch.exp2(-dm)
                l, acc = l * a, acc * a[:, None]
                p = _bf16(torch.exp2(s - dm[:, None]))
                rs = p.sum(1)
            l = l + rs                                    # the undropped sum
            if keep is not None:
                p = p * keep[rows][:, keys]
            acc = acc + p @ v[keys]
        out[rows] = _bf16(acc * mul / l[:, None])
        lse[rows] = m + torch.log2(l)
    return out[:seq], lse[:seq]


def core_backward(qp, kp, v, do, lse, delta, keep=None, mul=1.0):
    """#4's two score passes on one (row, head): ``(dQ, dK, dV)`` [L, 32]
    before the final scales and rotations, fp32."""
    seq = qp.shape[0]
    lpad = -(-seq // 64) * 64
    qp, kp, v, do = (_pad_rows(t, lpad) for t in (qp, kp, v, do))
    lse = torch.cat([lse, torch.full((lpad - seq,), math.inf)])
    delta = torch.cat([delta, torch.zeros(lpad - seq)])
    if keep is None:
        keep = torch.ones(lpad, lpad, dtype=torch.bool)
    else:
        keep = torch.nn.functional.pad(keep, (0, lpad - seq, 0, lpad - seq), value=True)
    live = torch.arange(lpad) < seq

    def ds_of(p, dp, kept, dl):
        return p * (torch.where(kept, dp * mul, torch.zeros(())) - dl)

    dq = torch.zeros(lpad, DP)
    for j0 in range(0, lpad, 16):                         # dq pass, 16 keys at a time
        ks = slice(j0, j0 + 16)
        p = torch.exp2(qp @ kp[ks].T - lse[:, None]) * live[ks][None, :]
        ds = _bf16(ds_of(p, do @ v[ks].T, keep[:, ks], delta[:, None]))
        dq = dq + ds @ kp[ks]
    dk, dv = torch.zeros(lpad, DP), torch.zeros(lpad, DP)
    for i0 in range(0, lpad, 16):                         # dk/dv pass, 16 queries at a time
        qs = slice(i0, i0 + 16)
        pt = torch.exp2(kp @ qp[qs].T - lse[qs][None, :])
        kt = keep[qs].T
        dv = dv + _bf16(pt * kt) @ do[qs]
        dk = dk + _bf16(ds_of(pt, v @ do[qs].T, kt, delta[qs][None, :])) @ qp[qs]
    return dq[:seq], dk[:seq], dv[:seq]


def _wo_panel(w_out, h):
    """The out-projection as the kernels take it: ``[H*32, C]``, zero rows
    for head dims >= D."""
    c, a = w_out.shape
    d = a // h
    wo = torch.zeros(h, DP, c)
    wo[:, :d] = _bf16(w_out).T.reshape(h, d, c)
    return wo.reshape(h * DP, c)


def emulate_step(x, gamma, w_qkv, w_out, h, rope, g=None, p=0.0, seed=0, row0=0):
    """#3 (and, with the cotangent ``g``, #4) on fp32 rows ``x [R, L, C]``:
    ``out`` or ``(out, (dx, dgamma, dw_qkv, dw_out))``."""
    r, seq, c = x.shape
    a = w_qkv.shape[0] // 3
    d, dpg = a // h, c // GROUPS
    xg = x.reshape(r, seq, GROUPS, dpg)
    inv = 1.0 / (xg.pow(2).sum(-1, keepdim=True).sqrt() * dpg ** -0.5 + EPS)
    xn = _bf16((xg * inv).reshape(r, seq, c) * gamma)
    q, k, v = _bf16(xn @ _bf16(w_qkv).T).reshape(r, seq, 3, h, d).permute(2, 0, 3, 1, 4)
    # without RoPE the kernels rotate by identity tables
    cos, sin = rope_angles(seq, d) if rope else (torch.ones(seq, d // 2), torch.zeros(seq, d // 2))
    q, k = _rot(q, cos, sin), _rot(k, cos, sin)
    qp, kp = _bf16(q * (d ** -0.5 * LOG2E)), _bf16(k)
    qp, kp, vp = (torch.nn.functional.pad(t, (0, DP - d)) for t in (qp, kp, v))
    rows = torch.arange(row0, row0 + r)
    mul = 1.0 / (1.0 - p) if p > 0 else 1.0
    keep = AB.probability_mask(seed, rows, h, seq, p) if p > 0 else None
    o, lse = torch.empty(r, h, seq, DP), torch.empty(r, h, seq)
    for i in range(r):
        for j in range(h):
            o[i, j], lse[i, j] = core_forward(qp[i, j], kp[i, j], vp[i, j],
                                              None if keep is None else keep[i, j], mul)
    o_all = o.permute(0, 2, 1, 3).reshape(r, seq, h * DP)
    wo = _wo_panel(w_out, h)
    z = o_all @ wo
    pkeep = DR.row_mask(seed, DR.SITE_ATTN_PROJ, x, row0, p) if p > 0 else None
    if p > 0:
        z = torch.where(pkeep, z * mul, torch.zeros(()))
    out = _bf16(x + z)
    if g is None:
        return out
    dproj = _bf16(torch.where(pkeep, g * mul, torch.zeros(())) if p > 0 else g)
    do = _bf16(dproj @ wo.T).reshape(r, seq, h, DP).permute(0, 2, 1, 3)
    delta = (do * o).sum(-1)
    grads = torch.empty(3, r, h, seq, d)
    for i in range(r):
        for j in range(h):
            dq, dk, dv = core_backward(qp[i, j], kp[i, j], vp[i, j], do[i, j], lse[i, j],
                                       delta[i, j], None if keep is None else keep[i, j], mul)
            grads[0, i, j] = _rot(dq[:, :d] * d ** -0.5, cos, sin, True)
            grads[1, i, j] = _rot(dk[:, :d] * LN2, cos, sin, True)
            grads[2, i, j] = dv[:, :d] * mul
    dqkv = _bf16(grads).permute(1, 3, 0, 2, 4).reshape(r, seq, 3 * a)
    dxn = dqkv @ _bf16(w_qkv)
    gam = gamma.reshape(GROUPS, dpg)
    dxg = dxn.reshape(r, seq, GROUPS, dpg)
    rr = xg.pow(2).sum(-1, keepdim=True).sqrt() * dpg ** -0.5
    tsum = (gam * dxg * xg).sum(-1, keepdim=True)
    k2 = torch.where(rr > 0, tsum * inv * inv / (dpg * rr), torch.zeros(()))
    dx = _bf16((gam * dxg * inv - xg * k2).reshape(r, seq, c) + g)
    dgamma = (dxg * xg * inv).reshape(-1, c).sum(0)
    dw_qkv = dqkv.reshape(-1, 3 * a).T @ xn.reshape(-1, c)
    dwo = (o_all.reshape(-1, h * DP).T @ dproj.reshape(-1, c)).reshape(h, DP, c)[:, :d]
    return out, (dx, dgamma, dw_qkv, dwo.reshape(a, c).T)


def _inputs(seed, r, seq, c, a):
    """bf16-representable fp32 rows, weights and cotangent (QKV at twice
    torch's init scale: a peaked softmax)."""
    rng = np.random.default_rng(seed)
    f = lambda v: _bf16(torch.from_numpy(np.asarray(v, np.float32))).numpy()
    return (f(0.5 * rng.standard_normal((r, seq, c))), f(1 + 0.1 * rng.standard_normal(c)),
            f(rng.uniform(-2, 2, (3 * a, c)) / np.sqrt(c)),
            f(rng.uniform(-1, 1, (c, a)) / np.sqrt(a)), f(rng.standard_normal((r, seq, c))))


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= TOL * np.abs(want).max(), (name, err, np.abs(want).max())


# (rows, L, C, A, heads, RoPE): D 32 and 24, RoPE on and off; L 1, one
# 64-key tile and a 16-key tail, two full tiles and a tail with one live
# key.  A JAX run costs ~4-5 s a kernel (the interpret-mode compiles), so
# L 1 holds the forward alone and D 32 with RoPE runs in the dropout test.
CASES = [(2, 1, 64, 64, 2, True), (2, 65, 64, 64, 2, False), (2, 129, 64, 48, 2, True)]
BACKWARD_CASES = CASES[1:]


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX fused step in interpret mode: ``(out, (dx, dgamma, dw_qkv,
    dw_out))`` as numpy (no gradients outside ``BACKWARD_CASES``), once per
    shape."""
    r, seq, c, a, h, rope = case
    x, gamma, w_qkv, w_out, g = _inputs(CASES.index(case), r, seq, c, a)
    fn = lambda *p: JAB.fused_attention_block(*p, h, GROUPS, EPS, rope)
    args = tuple(map(jnp.asarray, (x, gamma, w_qkv, w_out)))
    with pltpu.force_tpu_interpret_mode():
        if case not in BACKWARD_CASES:
            return np.asarray(fn(*args)), None
        out, vjp = jax.vjp(fn, *args)
        grads = vjp(jnp.asarray(g))
    return np.asarray(out), tuple(np.asarray(t) for t in grads)


def _emulated(case, grads):
    r, seq, c, a, h, rope = case
    x, gamma, w_qkv, w_out, g = (torch.from_numpy(t) for t in
                                 _inputs(CASES.index(case), r, seq, c, a))
    return emulate_step(x, gamma, w_qkv, w_out, h, rope, g if grads else None)


@pytest.mark.parametrize("case", CASES)
def test_forward_plan_matches_jax(case):
    want, _ = _jax_run(case)
    _close(_emulated(case, False).numpy(), want, "out")


@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_backward_plan_matches_jax(case):
    _, want = _jax_run(case)
    out, got = _emulated(case, True)
    for name, a, w in zip(("dx", "dgamma", "dw_qkv", "dw_out"), got, want):
        _close(a.numpy(), w, name)


@pytest.mark.parametrize("seq,c,a,h", [(1, 64, 64, 2), (70, 64, 64, 2), (130, 96, 96, 4)])
def test_dropout_plan_matches_the_plain_version(seq, c, a, h):
    """At dropout 0.1 (both sites, rows offset by ``row0``) the emulation
    against the port's plain version, whose masks are the kernels' bits."""
    x, gamma, w_qkv, w_out, g = (torch.from_numpy(t) for t in _inputs(9, 2, seq, c, a))
    args = (h, GROUPS, EPS, True, 10000.0, 0.1, 4321, 3)
    out, grads = emulate_step(x, gamma, w_qkv, w_out, h, True, g, 0.1, 4321, 3)
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, w_qkv, w_out)]
    ref = AB.reference_attention_block(*leaves, *args)
    want = torch.autograd.grad(ref, leaves, g)
    _close(out.numpy(), ref.detach().numpy(), "out")
    for name, got, w in zip(("dx", "dgamma", "dw_qkv", "dw_out"), grads, want):
        _close(got.numpy(), w.numpy(), name)


def test_lazy_rescale_catches_rising_scores():
    """Keys whose scores rise along the sequence push the max past the first
    tile's by more than 16 (log2 units): the exact path must run on later
    tiles, and the core still match fp32 softmax attention."""
    rng = np.random.default_rng(3)
    seq, d = 200, 32
    q = torch.from_numpy(np.abs(rng.standard_normal((seq, d))).astype(np.float32))
    k = torch.from_numpy((np.abs(rng.standard_normal((seq, d)))
                          * np.linspace(0.1, 4.0, seq)[:, None]).astype(np.float32))
    v = _bf16(torch.from_numpy(rng.standard_normal((seq, d)).astype(np.float32)))
    qp, kp = _bf16(q * (d ** -0.5 * LOG2E)), _bf16(k)
    stats = {"rescales": 0}
    o, lse = core_forward(qp, kp, v, stats=stats)
    assert stats["rescales"] > 0
    s = (qp @ kp.T) * LN2                                  # natural-log scores
    want = torch.softmax(s, -1) @ v
    _close(o.numpy(), want.numpy(), "o")
    _close(lse.numpy() * LN2, torch.logsumexp(s, -1).numpy(), "lse")


def test_layouts_and_routes_of_the_shipped_shapes():
    """The gate's layout bytes at the base and BS widths, the resident core
    at every shipped sequence length (k and v of L 1025: 2 x 1040 rows of 64
    bytes, and 8 mbarriers), the streaming core beyond 1808, and the gate
    admitting the base, lowmem, medium, BS, speech and the tests' emb-32
    configs in eval and training, and BS training at C 128."""
    tile = 64 * 64
    assert AB.launch_bytes(96, 96, 4, True) == {
        "qkv": (64 + 96) * 13 * 16, "core": 4 * tile,
        "out": 64 * 17 * 16 + 128 * 13 * 16, "bwd_pre": 64 * 112 * 2 + 64 * 132 * 4,
        "bwd_dq": 4 * tile, "bwd_dkdv": 2 * (2 * tile + 512 + 1024),
        "bwd_final": 64 * 17 * 16 + 128 * 13 * 16}
    assert AB.launch_bytes(128, 128, 4)["out"] == 64 * 17 * 16 + 128 * 17 * 16
    assert AB.core_resident_bytes(1025) == 2 * 1040 * 64 + 64 == 133184
    for seq in (1025, 690, 259, 62, 1, 1400, 1808):    # base, training, BS, beyond
        assert AB.core_resident(seq), seq
    assert not AB.core_resident(1809) and not AB.core_resident(2049)
    for c, a, h in ((96, 96, 4), (128, 128, 8), (128, 128, 4), (32, 32, 2), (64, 64, 4)):
        for training in (False, True):
            assert AB.supports_block(c, a, h, training), (c, a, h, training)
    assert max(AB.launch_bytes(128, 128, 4, True).values()) <= SMEM_OPTIN
    assert not AB.supports_block(256, 256, 16, False)   # xlarge: the unfused route
