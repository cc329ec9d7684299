"""The flash-attention kernels' schedule (#6 forward, #7 backward) on the CPU.

``csrc/flash_attention.cu`` runs on the card only, so its arithmetic is
emulated here in plain torch, step for step:

* forward: q rotated in fp32, times ``scale * log2(e)``, rounded to bf16
  once (k rotated and rounded likewise); per 16-query tile, 64-key tiles
  while they are full, then 16-key tiles with keys >= L masked; P taken
  with the old running max (0 at first), which moves to the row's max only
  when a row's tile sum of the bf16 P passes 2^16 or, in the first tile,
  falls below 1 (the lazy rescale; the warp's 16 rows together); P rounded
  to bf16 before P V and summed as rounded; the natural log-sum-exp
  stashed;
* backward: the one-pass resident kernel: delta = rowsum(dO o) in the pass,
  P^T = ex2(K Q'^T - lse log2 e) per (slab of 16 keys, 16-query tile), dS^T
  = P^T (V dO^T - delta), P^T and dS^T rounded to bf16 as the products'
  operands, dK and dV summed per slab, dQ's per-warp partials (the warps'
  slabs as the kernel's plan deals them) summed in warp order.

The emulation is held against the JAX package's ``flash_attention`` and its
Pallas backward in interpret mode (as tests/test_torch_unfused*.py run them
on the CPU) at tiny shapes, and against the port's plain version at the
main path's plan (33 slabs on 11 warps)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.ops.pallas import flash_attention as JFA
from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
from mss_tf_locoformer_tpu_torch.ops.rope import rope_angles

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
LAZY_LIMIT = 65536.0   # csrc/flash_attention.cu's LAZY_LIMIT
# The emulation rounds q', P and dS to bf16 as the kernels do; the JAX
# kernels and the plain version run in fp32 on the same bf16-representable
# inputs.  Each rounding moves a term by at most one bf16 step (2^-8 of it),
# so outputs and gradients land within a few steps of the largest: 2e-2 of
# max|ref| (the card's STEP_TOL).  A wrong mask, tile, rescale or sum is
# O(1).
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


def _operands(q, k, rope, theta=10000.0):
    """q' = bf16(R(q) scale log2 e) and k' = bf16(R(k)), both [L, D]."""
    seq, d = q.shape
    cos, sin = rope_angles(seq, d, theta)
    qr, kr = (_rot(t, cos, sin) if rope else t for t in (q, k))
    return _bf16(qr * (d ** -0.5 * LOG2E)), _bf16(kr), cos, sin


def _pad(x, lp):
    return torch.cat([x, x.new_zeros(lp - x.shape[0], x.shape[1])])


def emulate_forward(q, k, v, rope, stats=None):
    """#6 on one (row, head): ``(o bf16-rounded [L, D], lse [L])``."""
    seq, d = q.shape
    lp = -(-seq // 16) * 16
    qp, kp, _, _ = _operands(q, k, rope)
    qp, kp, vp = _pad(qp, lp), _pad(kp, lp), _pad(v, lp)
    tiles, j0 = [], 0
    while j0 + 64 <= seq:
        tiles.append((j0, 64))
        j0 += 64
    while j0 < seq:
        tiles.append((j0, 16))
        j0 += 16
    out, lse = torch.empty(lp, d), torch.empty(lp)
    for t in range(lp // 16):
        rows = slice(16 * t, 16 * t + 16)
        m, l, acc = torch.zeros(16), torch.zeros(16), torch.zeros(16, d)
        for i, (j0, nk) in enumerate(tiles):
            keys = torch.arange(j0, j0 + nk)
            s = qp[rows] @ kp[keys].T - m[:, None]        # the MMA started at -m
            s[:, keys >= seq] = -math.inf
            p = _bf16(torch.exp2(s))                      # with the old m (0 at first)
            rs = p.sum(1)
            bad = ~(rs <= LAZY_LIMIT)
            if i == 0:
                bad |= ~(rs >= 1.0)
            if bool(bad.any()):                           # the warp's 16 rows together
                if stats is not None and i > 0:
                    stats["rescales"] += 1
                mx = s.max(1).values
                dm = mx if i == 0 else mx.clamp(min=0.0)
                m = m + dm
                a = torch.exp2(-dm)
                l, acc = l * a, acc * a[:, None]
                p = _bf16(torch.exp2(s - dm[:, None]))
                rs = p.sum(1)
            l = l + rs
            acc = acc + p @ vp[keys]
        out[rows] = _bf16(acc / l[:, None])
        lse[rows] = (m + torch.log2(l)) * LN2
    return out[:seq], lse[:seq]


def backward_plan(seq):
    """``(slabs, per_warp, warps)`` of the resident backward."""
    slabs = -(-seq // 16)
    per_warp = -(-slabs // FA._BW_WARPS)
    return slabs, per_warp, -(-slabs // per_warp)


def emulate_backward(q, k, v, o, lse, g, rope):
    """#7's resident pass on one (row, head): ``(dq, dk, dv)``, bf16-rounded."""
    seq, d = q.shape
    lp = -(-seq // 16) * 16
    qp, kp, cos, sin = _operands(q, k, rope)
    qp, kp, vp, gp = (_pad(t, lp) for t in (qp, kp, v, g))
    nlse = torch.full((lp,), -math.inf)
    nlse[:seq] = -lse * LOG2E
    ndel = torch.zeros(lp)
    ndel[:seq] = -(g * o).sum(1)                       # delta in the pass
    slabs, per_warp, warps = backward_plan(seq)
    dk, dv, dq = torch.zeros(lp, d), torch.zeros(lp, d), torch.empty(lp, d)
    for t in range(lp // 16):
        qs = slice(16 * t, 16 * t + 16)
        partial = []
        for w in range(warps):
            dqt = torch.zeros(d, 16)
            for i in range(per_warp):
                slab = w * per_warp + i
                if slab >= slabs:
                    break
                ks = slice(16 * slab, 16 * slab + 16)
                p = torch.exp2(kp[ks] @ qp[qs].T + nlse[qs][None, :])
                p[torch.arange(16 * slab, 16 * slab + 16) >= seq] = 0.0
                dp = vp[ks] @ gp[qs].T + ndel[qs][None, :]
                pp, ps = _bf16(p), _bf16(p * dp)
                dv[ks] += pp @ gp[qs]
                dk[ks] += ps @ qp[qs]
                dqt += kp[ks].T @ ps
            partial.append(dqt)
        total = partial[0]
        for part in partial[1:]:                       # warp order
            total = total + part
        dq[qs] = total.T * d ** -0.5
    dq, dk = dq[:seq], dk[:seq] * LN2
    if rope:
        dq, dk = _rot(dq, cos, sin, True), _rot(dk, cos, sin, True)
    return _bf16(dq), _bf16(dk), _bf16(dv[:seq])


def _inputs(rng, seq, d, n=4, scale=1.5):
    """bf16-representable fp32 [1, 2, L, D] arrays (two heads)."""
    return [_bf16(torch.from_numpy(scale * rng.standard_normal((1, 2, seq, d)))).numpy()
            for _ in range(n)]


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= TOL * np.abs(want).max(), (name, err, np.abs(want).max())


def _emulate_heads(fn, *arrays):
    """Apply a per-(row, head) emulation over [1, H, L, D] arrays."""
    outs = [fn(*(torch.from_numpy(a[0, h]) for a in arrays)) for h in range(arrays[0].shape[1])]
    return [np.stack([o[i].numpy() for o in outs])[None] for i in range(len(outs[0]))]


TINY = [(1, 16, True), (17, 12, True), (65, 16, False), (129, 12, True)]


@pytest.mark.parametrize("seq,d,rope", TINY)
def test_forward_plan_matches_jax(rng, seq, d, rope):
    q, k, v = _inputs(rng, seq, d, 3)
    got, _ = _emulate_heads(lambda *a: emulate_forward(*a, rope), q, k, v)
    with pltpu.force_tpu_interpret_mode():
        want = JFA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rope)
    _close(got, want, "o")


@pytest.mark.parametrize("seq,d,rope", TINY)
def test_backward_plan_matches_jax(rng, seq, d, rope):
    q, k, v, g = _inputs(rng, seq, d, 4)
    o, lse = _emulate_heads(lambda *a: emulate_forward(*a, rope), q, k, v)
    got = _emulate_heads(lambda *a: emulate_backward(*a, rope), q, k, v, o, lse, g)
    with pltpu.force_tpu_interpret_mode():
        want = JFA._flash_backward_pallas(*(jnp.asarray(a) for a in (q, k, v, g)), rope,
                                          10000.0)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a, w, name)


def _plain(q, k, v, g, rope):
    """The port's plain version and autograd through it, fp32."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = FA.reference_flash_attention(*leaves, rope)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return out.detach().numpy(), [t.numpy() for t in grads]


@pytest.mark.parametrize("seq,d,rope", [(513, 12, True), (345, 16, True), (200, 16, False)])
def test_plan_at_the_main_path_matches_the_plain_version(rng, seq, d, rope):
    """The small training shape's plan (33 slabs on 11 warps of 3), xlarge
    time's (22 on 11 of 2) and a plan with a short last warp (13 slabs on 7
    warps of 2), against the plain version."""
    q, k, v, g = (a[:, :1] for a in _inputs(rng, seq, d, 4))
    o, lse = _emulate_heads(lambda *a: emulate_forward(*a, rope), q, k, v)
    dq, dk, dv = _emulate_heads(lambda *a: emulate_backward(*a, rope), q, k, v, o, lse, g)
    want, grads = _plain(q, k, v, g, rope)
    _close(o, want, "o")
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        _close(a, w, name)


def test_lazy_rescale_catches_rising_scores(rng):
    """Keys whose scores rise along the sequence push the max past the first
    tile's by more than 16 (log2 units): the exact path must run on later
    tiles, and the result still match the plain version."""
    seq, d = 200, 16
    q, k, v, g = _inputs(rng, seq, d, 4, scale=1.0)
    q[..., :] = np.abs(q)
    k = _bf16(torch.from_numpy(np.abs(k) * np.linspace(0.1, 4.0, seq)[:, None])).numpy()
    stats = {"rescales": 0}
    o, _ = _emulate_heads(lambda *a: emulate_forward(*a, False, stats), q, k, v)
    assert stats["rescales"] > 0
    want, _ = _plain(q, k, v, g, False)
    _close(o, want, "o")


def test_plans_of_the_shipped_shapes():
    """The backward's plan spreads the small training shape's 33 slabs of 16
    keys evenly (11 warps of 3; 517 rounds to the same 528 rows), and the
    gates pin the .cu layouts' bytes: q, k and v of xlarge freq resident (3
    x 2049 rows padded to 2064 of 32 bytes), the backward resident at small
    training and xlarge time, streaming at xlarge freq and beyond D 16."""
    assert backward_plan(513) == backward_plan(517) == (33, 3, 11)
    assert backward_plan(345) == (22, 2, 11)
    assert FA.forward_resident_bytes(2049, 16) == 3 * 2064 * 32 == 198144
    assert FA.forward_resident_bytes(513, 12) == 3 * 528 * 32
    assert FA.forward_resident_bytes(600, 48) == 3 * 608 * 7 * 16
    assert not FA.forward_resident(2500, 16) and not FA.forward_resident(1000, 64)
    assert FA.backward_resident_bytes(513, 12) == 2 * (5 * 528 * 32 + 8 * 528) + 2 * 11 * 1536
    assert FA.backward_resident(345, 16) and FA.backward_resident(1, 16)
    assert not FA.backward_resident(2049, 16) and not FA.backward_resident(513, 32)
    assert not FA.backward_resident(600, 16)
