"""The 3xTF32 attention core's arithmetic (#6 / #7 at fp32, and the core of
#3 / #4's fp32 rows) on the CPU.

``csrc/attn_fp32.cu`` runs on the card only, so its arithmetic is emulated
here in plain torch (:class:`AttnTf32Prims`: ``TorchPrims`` with the core's
``attn_fwd`` / ``attn_bwd``), on the ``[R, H, Lp, DP]`` operands the chain
lays out:

* operands split into TF32 halves by round-to-nearest (``rna`` / ``split``
  of tests/test_torch_fp32_ffn_plan.py); per k step three products summed
  in fp32, the small ones first (lo hi', hi lo', hi hi'); over the head dims
  k8 steps while more than 4 dims remain, then one k4 step (D 12: 8 + 4;
  D 24: three of DP 32's four; a head dim other than the shipped 12, 16,
  24, 32 over the padded width), over keys (queries) k8 steps;
* the forward in the exp2 domain: q' = q scale log2 e, the accumulator
  started at -m, P = 2^S'; 16-key tiles while a 64-key chunk holds them,
  then 8-key tail tiles with the keys past L masked; the lazy
  max per warp (16 rows, 32 at DP 16): the exact rescale only when a lane's
  share of a row's tile sum (columns 2c, 2c + 1 of each 8-key group) leaves
  [0, 2^14] or the first tile's row sum is below 1; each tile's P V in a
  fresh sum added into O; the probability mask after the undropped sums;
* the backward's dq pass (delta = dO . o in three passes as dP's products;
  P from the natural log-sum-exp times log2 e, dP = dO v^T, dS = P
  (drop(dP) - delta), dQ += dS k a tile at a time) and dk/dv pass (k' = k
  scale log2 e, the same tiles over queries).

The emulation is held against the JAX package's flash attention and its
Pallas backward in interpret mode, against the fused attention step's
Pallas forward and backward (``_attn_forward`` / ``_attn_backward_pallas``)
at dropout 0, and against the port's plain versions at dropout 0.1, within
``TOL`` of max|ref| (outputs) and ``REL_L2`` (gradients).  One TF32 pass
misses those tolerances; three meet them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
from test_torch_fp32_ffn_plan import REL_L2, rna, split
from test_torch_fp32_steps import TOL, TorchPrims

from mss_tf_locoformer_tpu.ops.pallas import attention_block as JAB
from mss_tf_locoformer_tpu.ops.pallas import flash_attention as JFA

LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
LANE_LIMIT = 16384.0     # a lane's share of a row's tile sum: 2^16 / 4
CHUNK = 64               # keys (queries) a staged chunk


def dim_steps(d, dp=None):
    """The k steps over the head dims the kernels cover: the shipped head dims
    (12, 16, 24, 32) rounded up to 4, 8 wide while more than 4 dims remain,
    then 4; any other head dim the padded width ``dp`` (zero past D)."""
    dk = d if d in (12, 16, 24, 32) or dp is None else dp
    steps, k0 = [], 0
    while k0 < dk:
        w = 8 if dk - k0 > 4 else 4
        steps.append((k0, w))
        k0 += w
    return steps


def tile_plan(seq, nj):
    """(first key, keys, masked) of each score tile: per 64-key chunk, tiles
    of 8 nj keys while the chunk holds them, then 8-key tiles whose keys
    past ``seq`` are masked."""
    out = []
    for kt in range(0, seq, CHUNK):
        nk, j0 = min(CHUNK, seq - kt), 0
        while j0 + 8 * nj <= nk:
            out.append((kt + j0, 8 * nj, False))
            j0 += 8 * nj
        while j0 < nk:
            out.append((kt + j0, 8, True))
            j0 += 8
    return out


def score_nj(dp):
    """n8 tiles of a score tile: 16 keys (queries) at every head width."""
    return 2


def warp_rows(dp):
    """Rows a warp of the forward holds (two m16 tiles at DP 16)."""
    return 32 if dp == 16 else 16


def mm3(a, b, steps, passes=3, c=None):
    """``a [..., M, K] @ b [..., K, N]`` as the kernels sum it: from ``c``,
    per k step lo hi', hi lo', hi hi' in fp32 (``passes`` 1: the rounded
    operands' product alone)."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    acc = c
    for k0, w in steps:
        s = slice(k0, k0 + w)
        terms = [(alo, bhi), (ahi, blo), (ahi, bhi)] if passes == 3 else [(ahi, bhi)]
        for x, y in terms:
            t = x[..., s] @ y[..., s, :]
            acc = t if acc is None else acc + t
    return acc


def _key_steps(n):
    return [(k0, 8) for k0 in range(0, n, 8)]


def _fp32(x):
    return np.float32(x)


def core_forward(q, k, v, seq, d, scale, keep=None, dscale=1.0, passes=3, log=None):
    """The forward kernel on ``[B, Lp, DP]`` operands (B = R H): ``(o [B, L,
    DP], lse [B, L])``, lse natural; ``keep [B, L(query), L(key)]``; ``log``
    collects the tiles that took the exact rescale."""
    b, lp, dp = q.shape
    nj, wr = score_nj(dp), warp_rows(dp)
    qp = q * _fp32(_fp32(scale) * LOG2E)
    steps = dim_steps(d, dp)
    m, l = torch.zeros(b, lp), torch.zeros(b, lp)
    acc = torch.zeros(b, lp, dp)
    if keep is not None:
        keep = torch.nn.functional.pad(keep, (0, lp - seq, 0, lp - seq))
    first = True
    for k0, n, masked in tile_plan(seq, nj):
        kt, vt = k[:, k0:k0 + n], v[:, k0:k0 + n]
        s = mm3(qp, kt.transpose(-1, -2), steps, passes, c=(-m)[..., None].expand(b, lp, n))
        if masked:
            s[..., max(seq - k0, 0):] = -torch.inf
        p = torch.exp2(s)
        share = p.view(b, lp, n // 8, 4, 2).sum((2, 4))          # lane c's columns
        bad = ~(share <= LANE_LIMIT).all(-1)
        if first:
            bad |= ~(p.sum(-1) >= 1)
        bad = bad.view(b, lp // wr, wr).any(-1).repeat_interleave(wr, -1)   # per warp
        if bad.any():
            mx = s.amax(-1)
            dm = torch.where(bad, mx if first else mx.clamp(min=0), torch.zeros(()))
            m, a_ = m + dm, torch.exp2(-dm)
            l, acc = l * a_, acc * a_[..., None]
            s = s - dm[..., None]
            p = torch.exp2(s)
            if log is not None:
                log.append((k0, int(bad.sum())))
        first = False
        l = l + p.sum(-1)
        if keep is not None:
            p = torch.where(keep[:, :, k0:k0 + n], p, torch.zeros(()))
        acc = acc + mm3(p, vt, _key_steps(n), passes)
    o = acc * _fp32(dscale) / l[..., None]
    lse = (m + torch.log2(l)) * LN2
    return o[:, :seq], lse[:, :seq]


def core_backward(q, k, v, o, dout, lse, seq, d, scale, keep=None, dscale=1.0, passes=3):
    """The dq and dk/dv kernels on ``[B, Lp, DP]`` operands, ``o`` / ``dout``
    ``[B, L, D]``, ``lse [B, L]``: ``(dq, dk, dv [B, L, DP], dO [B, Lp, DP],
    delta [B, L])``, dq and dk not yet rotated back."""
    b, lp, dp = q.shape
    nj = score_nj(dp)
    steps = dim_steps(d, dp)
    do = torch.zeros(b, lp, dp)
    do[:, :seq, :d] = dout
    ob = torch.zeros(b, lp, dp)
    ob[:, :seq, :d] = o
    # delta = dO . o row by row on the tensor cores, dP's products in their order
    delta = mm3(do[..., None, :], ob[..., :, None], steps, passes)[..., 0, 0]
    lse2 = torch.zeros(b, lp)
    lse2[:, :seq] = lse * LOG2E
    mul = _fp32(_fp32(scale) * LOG2E)
    if keep is not None:
        keep = torch.nn.functional.pad(keep, (0, lp - seq, 0, lp - seq))
    qp, kp = q * mul, k * mul
    # dq: a warp's queries against the key tiles
    dq = torch.zeros(b, lp, dp)
    for k0, n, masked in tile_plan(seq, nj):
        kt, vt = k[:, k0:k0 + n], v[:, k0:k0 + n]
        s = mm3(qp, kt.transpose(-1, -2), steps, passes, c=(-lse2)[..., None].expand(b, lp, n))
        if masked:
            s[..., max(seq - k0, 0):] = -torch.inf
        dpv = mm3(do, vt.transpose(-1, -2), steps, passes)
        if keep is not None:
            dpv = torch.where(keep[:, :, k0:k0 + n], dpv * _fp32(dscale), torch.zeros(()))
        ds = torch.exp2(s) * (dpv - delta[..., None])
        dq = dq + mm3(ds, kt, _key_steps(n), passes)
    # dk / dv: a warp's keys against the query tiles
    dk, dv = torch.zeros(b, lp, dp), torch.zeros(b, lp, dp)
    for q0, n, masked in tile_plan(seq, nj):
        qt, dot = q[:, q0:q0 + n], do[:, q0:q0 + n]
        st = mm3(kp, qt.transpose(-1, -2), steps, passes,
                 c=(-lse2[:, q0:q0 + n])[:, None].expand(b, lp, n))
        if masked:
            st[..., max(seq - q0, 0):] = -torch.inf
        pt = torch.exp2(st)
        dpt = mm3(v, dot.transpose(-1, -2), steps, passes)
        pd = pt
        if keep is not None:
            kt_ = keep[:, q0:q0 + n].transpose(-1, -2)
            pd = torch.where(kt_, pt, torch.zeros(()))
            dpt = torch.where(kt_, dpt * _fp32(dscale), torch.zeros(()))
        dv = dv + mm3(pd, dot, _key_steps(n), passes)
        dk = dk + mm3(pt * (dpt - delta[:, q0:q0 + n][:, None]), qt, _key_steps(n), passes)
    dq, dk, dv = dq * _fp32(scale), dk * _fp32(scale), dv * _fp32(dscale)
    return dq[:, :seq], dk[:, :seq], dv[:, :seq], do, delta[:, :seq]


class AttnTf32Prims(TorchPrims):
    """``TorchPrims`` with the attention core of ``csrc/attn_fp32.cu``
    emulated (``attn_fwd``, ``attn_bwd``); ``passes`` 1 takes one TF32 pass
    instead of three.  ``exact`` collects the forward's exact rescales."""

    def __init__(self, passes=3):
        super().__init__()
        self.passes, self.exact = passes, []

    def _keep(self, drop, r, h, seq):
        if not drop[4]:
            return None
        return self._prob_keep(drop, r, h, seq).reshape(r * h, seq, seq)

    def attn_fwd(self, q, k, v, o, lse, r, h, seq, lp, d, scale, drop):
        self._count("attn_fwd")
        dp = q.shape[-1]
        out, ls = core_forward(q.reshape(r * h, lp, dp), k.reshape(r * h, lp, dp),
                               v.reshape(r * h, lp, dp), seq, d, scale,
                               self._keep(drop, r, h, seq), drop[3] if drop[4] else 1.0,
                               self.passes, self.exact)
        o.copy_(out[..., :d].reshape(r, h, seq, d).transpose(1, 2).reshape(r, seq, h * d))
        if lse is not None:
            lse.copy_(ls.reshape(r, h, seq))

    def attn_bwd(self, q, k, v, o, dout, lse, dop, delta, dqkv, cos, sin, r, h, seq, lp, d,
                 scale, drop):
        self._count("attn_bwd")
        dp, a = q.shape[-1], h * d
        heads = lambda t: t.reshape(r, seq, h, d).transpose(1, 2).reshape(r * h, seq, d)
        dq, dk, dv, do, dl = core_backward(
            q.reshape(r * h, lp, dp), k.reshape(r * h, lp, dp), v.reshape(r * h, lp, dp),
            heads(o), heads(dout), lse.reshape(r * h, seq), seq, d, scale,
            self._keep(drop, r, h, seq), drop[3] if drop[4] else 1.0, self.passes)
        dop.copy_(do.reshape(dop.shape))
        delta.copy_(dl.reshape(delta.shape))

        def unrot(z):
            e, od = z[..., 0::2], z[..., 1::2]
            return torch.stack([e * cos + od * sin, od * cos - e * sin], -1).flatten(-2)
        flat = lambda z: z[..., :d].reshape(r, h, seq, d).transpose(1, 2).reshape(r, seq, a)
        dqkv.copy_(torch.cat([flat(unrot(dq[..., :d])), flat(unrot(dk[..., :d])), flat(dv)], -1))


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _relerr(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


# ------------------------------------------------------ #6 / #7 against JAX

# (L, D, RoPE): L 1, the 65- and 129-position tails of the 64-key chunks;
# D 12 (a k8 and a k4 step, DP 16), 16, 24 (DP 32's first three steps), 32;
# RoPE on and off.  A JAX run costs several seconds (the interpret-mode
# compiles), so the cases cover each value once or twice, not every triple.
FLASH_CASES = [(1, 12, True), (129, 16, False), (65, 24, True), (129, 32, True),
               (65, 12, False)]


@functools.lru_cache(maxsize=None)
def _flash_case(seq, d, rope):
    """Inputs and the JAX flash attention's output and gradients in
    interpret mode, once per case."""
    rng = np.random.default_rng(100 + seq + d)
    b, h = 2, 2
    qkv = (0.7 * rng.standard_normal((b, seq, 3, h, d))).astype(np.float32)
    g = rng.standard_normal((b, h, seq, d)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(t)) for t in
                  np.moveaxis(qkv, 2, 0).transpose(0, 1, 3, 2, 4))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JFA.flash_attention(jq, jk, jv, rope))
        wgrads = tuple(np.asarray(t) for t in
                       JFA._flash_backward_pallas(jq, jk, jv, jnp.asarray(g), rope, 10000.0))
    return qkv, g, want, wgrads


def _run_flash(seq, d, rope, passes=3):
    qkv, g, want, wgrads = _flash_case(seq, d, rope)
    q, k, v = _t(qkv).permute(2, 0, 3, 1, 4)
    prims = AttnTf32Prims(passes)
    out, lse = U.flash_forward_fp32(q, k, v, rope, 10000.0, True, prims=prims)
    grads = U.flash_backward_fp32(_t(g).permute(0, 2, 1, 3), q, k, v, out, lse, rope, 10000.0,
                                  prims=prims)
    return out.permute(0, 2, 1, 3), grads, want, wgrads, prims


@pytest.mark.parametrize("seq,d,rope", FLASH_CASES)
def test_emulated_core_matches_jax_flash(seq, d, rope):
    out, grads, want, wgrads, prims = _run_flash(seq, d, rope)
    assert _err(out, want) <= TOL, _err(out, want)
    for name, a, w in zip(("dq", "dk", "dv"), grads, wgrads):
        if seq == 1 and name != "dv":   # softmax over one key: no gradient to q, k
            assert np.abs(a.numpy()).max() < 1e-6 and np.abs(w).max() < 1e-6
        else:
            assert _relerr(a, w) <= REL_L2, (name, _relerr(a, w))
    assert prims.calls == {"qkv_split": 2, "attn_fwd": 1, "attn_bwd": 1}


def test_one_tf32_pass_misses_the_tolerances_three_meet_them():
    """The same core with one TF32 pass (operands rounded to 11 bits) misses
    ``TOL`` on the output and ``REL_L2`` on the gradients; three passes meet
    both (the case above)."""
    out, grads, want, wgrads, _ = _run_flash(129, 16, False, passes=1)
    assert _err(out, want) > TOL
    assert max(_relerr(a, w) for a, w in zip(grads, wgrads)) > REL_L2
    out, grads, want, wgrads, _ = _run_flash(129, 16, False)
    assert _err(out, want) <= TOL
    assert max(_relerr(a, w) for a, w in zip(grads, wgrads)) <= REL_L2


# ------------------------------------------- #3 / #4's core against JAX

# (rows, L, C, A, heads, RoPE): D 24 and 32 at DP 32, the step's shapes cut
STEP_CASES = [(2, 65, 48, 48, 2, True), (2, 33, 64, 64, 2, False)]
GROUPS, EPS = 4, 1e-5


def _step_inputs(seed, r, seq, c, a):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((r, seq, c))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    w_qkv = ((rng.random((3 * a, c)) * 2 - 1) * 2 * c ** -0.5).astype(np.float32)
    w_out = ((rng.random((c, a)) * 2 - 1) * a ** -0.5).astype(np.float32)
    g = rng.standard_normal((r, seq, c)).astype(np.float32)
    return x, gamma, w_qkv, w_out, g


@pytest.mark.parametrize("case", STEP_CASES)
def test_emulated_core_in_the_step_matches_jax(case):
    """The fp32 attention step's chain with the emulated core against the
    JAX fused step's Pallas forward and backward at fp32, dropout 0."""
    r, seq, c, a, h, rope = case
    x, gamma, w_qkv, w_out, g = _step_inputs(STEP_CASES.index(case), r, seq, c, a)
    fn = lambda *p: JAB.fused_attention_block(*p, h, GROUPS, EPS, rope)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(fn, *map(jnp.asarray, (x, gamma, w_qkv, w_out)))
        wgrads = vjp(jnp.asarray(g))
    prims = AttnTf32Prims()
    args = (h, GROUPS, EPS, rope)
    out, stash = S.attention_forward(*map(_t, (x, gamma, w_qkv, w_out)), *args, stash=True,
                                     prims=prims)
    grads = S.attention_backward(_t(g), *map(_t, (x, gamma, w_qkv, w_out)), stash, *args,
                                 prims=prims)
    assert _err(out, want) <= TOL, _err(out, want)
    assert _err(grads[0], wgrads[0]) <= TOL, ("dx", _err(grads[0], wgrads[0]))
    for name, a_, w in zip(("dgamma", "dw_qkv", "dw_out"), grads[1:], wgrads[1:]):
        assert _relerr(a_, w) <= REL_L2, (name, _relerr(a_, w))
    assert prims.calls["attn_fwd"] == prims.calls["attn_bwd"] == 1


@pytest.mark.parametrize("seq,c,a,h", [(1, 48, 48, 4), (70, 64, 64, 2), (130, 96, 96, 4)])
def test_emulated_core_with_dropout_matches_the_plain_step(seq, c, a, h):
    """At dropout 0.1 (the probability mask and the projection's, rows
    offset by ``row0``) the step's chain with the emulated core against
    autograd through the port's plain version, whose masks are the kernels'
    bits."""
    x, gamma, w_qkv, w_out, g = map(_t, _step_inputs(9, 2, seq, c, a))
    args = (h, GROUPS, EPS, True, 10000.0, 0.1, 4321, 3)
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, w_qkv, w_out)]
    ref = AB.reference_attention_block(*leaves, *args)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    prims = AttnTf32Prims()
    out, stash = S.attention_forward(x, gamma, w_qkv, w_out, *args, stash=True, prims=prims)
    grads = S.attention_backward(g, x, gamma, w_qkv, w_out, stash, *args, prims=prims)
    assert _err(out, ref.detach()) <= TOL
    assert _err(grads[0], ref_grads[0]) <= TOL
    for a_, w in zip(grads[1:], ref_grads[1:]):
        assert _relerr(a_, w) <= REL_L2


# ---------------------------------------------------------- the plan

def test_lazy_rescale_catches_rising_scores():
    """Scores that rise along the keys (the max moves up tile after tile)
    send the warps through the exact rescale, and the result stays the
    softmax's; scores of one level keep the hot path after the first tile."""
    seq, d = 200, 16
    lp = 256
    q = torch.zeros(1, lp, 16)
    k = torch.zeros(1, lp, 16)
    v = torch.zeros(1, lp, 16)
    q[0, :seq, 0] = 4.0
    k[0, :seq, 0] = torch.linspace(-10, 40, seq)      # scores from -10 to 40
    v[0, :seq, :d] = torch.randn(seq, d, generator=torch.Generator().manual_seed(0))
    log = []
    o, lse = core_forward(q, k, v, seq, d, d ** -0.5, log=log)
    s = (q[0, :seq, :d] @ k[0, :seq, :d].T) * d ** -0.5
    want = torch.softmax(s.double(), -1) @ v[0, :seq, :d].double()
    assert _err(o[0, :, :d], want) <= TOL
    assert _err(lse[0], torch.logsumexp(s.double(), -1)) <= TOL
    assert len(log) >= 2 and log[0][0] == 0
    log = []
    k[0, :seq, 0] = 1.0
    core_forward(q, k, v, seq, d, d ** -0.5, log=log)
    assert [t for t, _ in log] in ([], [0])


def test_tile_plan_and_layouts_of_the_shipped_shapes():
    """The tiles at the shipped lengths (xlarge 2049 / 345, small 513 /
    517; every key in one tile), the head-dim steps, and the launches'
    shared memory: the gates' bytes, within the opt-in limit."""
    for seq in (1, 65, 129, 345, 513, 517, 1001, 2049):
        for nj in (2, 4):
            plan = tile_plan(seq, nj)
            keys = [k0 + i for k0, n, _ in plan for i in range(n)]
            assert keys == list(range(len(keys))) and seq <= len(keys) < seq + 8
            assert all(m == (k0 + n > seq or n == 8 != 8 * nj) for k0, n, m in plan
                       if k0 + n > seq)
    assert len(tile_plan(2049, 2)) == 128 + 1 and len(tile_plan(517, 2)) == 32 + 1
    assert [dim_steps(d, 32 if d > 16 else 16) for d in (12, 16, 24, 32, 2, 20)] == [
        [(0, 8), (8, 4)], [(0, 8), (8, 8)], [(0, 8), (8, 8), (16, 8)],
        [(0, 8), (8, 8), (16, 8), (24, 8)], [(0, 8), (8, 8)],
        [(0, 8), (8, 8), (16, 8), (24, 8)]]
    assert dim_steps(64, 64) == [(k, 8) for k in range(0, 64, 8)]
    for dp in (16, 32, 64):
        want = {"attn": 3 * 2 * 64 * (dp + 4) * 4, "dkdv": 3 * 2 * 64 * (dp + 4 + 1) * 4}
        assert S.attn_launch_bytes(dp) == want
        assert max(want.values()) <= S.SMEM_OPTIN
    assert U.flash_launch_bytes(12) == S.attn_launch_bytes(16)
    assert S.launch_bytes(128, 128, True)["dkdv"] == S.attn_launch_bytes(32)["dkdv"]


def test_split_halves_are_tf32():
    """The emulation's split is the kernels' (``cvt.rna`` twice): both
    halves TF32, hi the nearest TF32."""
    t = torch.randn(1000) * 30
    hi, lo = split(t)
    assert torch.equal(hi, rna(t)) and not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - t).abs() <= 2.0 ** -21 * t.abs()).all()
