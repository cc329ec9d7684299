"""The fp32 attention step's kernels (#3 forward, #4 backward at fp32) and the
fp32 norms of every fused step (#2-#5) on the CPU.

``ops/cuda/step_fp32.py``'s ``attention_forward`` / ``attention_backward``
run their four GEMMs on ``csrc/ffn_core_fp32.cu`` (``core_nn``: the QKV
product, the out-projection with the output epilogue at the projection
site, do and dxn; ``core_tn``: the two weight products) around the 3xTF32
attention core of ``csrc/attn_fp32.cu``, with ``csrc/step_fp32.cu``'s
norms, projection mask and fixed-order reductions.  Those run on the card
only, so their arithmetic is emulated here in plain torch
(:class:`AttnStepPrims`: the GEMMs as ``test_torch_fp32_step_plan.py``'s
``StepPrims``, the core as ``test_torch_fp32_attn_plan.py``'s
``AttnTf32Prims``, the norms summed in the kernels' order: a warp per
position, lane l holding channels 4l .. 4l + 3, each group's partials
summed by a tree over its lanes (or, for groups that straddle a lane's
channels, a butterfly over the 32 lanes), dgamma summed per warp over its
positions and then over the block's warps):

* the emulated chain against the JAX package's Pallas ``_attn_forward`` and
  ``_attn_backward_pallas`` in interpret mode at fp32 rows and dropout 0
  (C 32 / 64, A = C, H 2 / 4, L 65 / 1, one and two norm groups, the
  residual and the partial-sum mode), within ``TOL`` of max|ref| (outputs,
  dx) and ``REL_L2`` (the other gradients);
* at dropout 0.1, at a row offset, L 17, against autograd through the
  port's plain version (the attention step runs no row groups);
* the chain call for call, and on the card's prims no FFMA GEMM in any of
  #2-#5 (``step_fp32.CudaPrims`` has none left);
* the norms in the kernels' order against the plain norm and its autograd
  at every width the gates admit, groups that straddle a lane's float4
  included;
* the gates' layouts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.ops.pallas import attention_block as JAB
from mss_tf_locoformer_tpu_torch.nn.norms import rms_group_norm
from mss_tf_locoformer_tpu_torch.ops.cuda import SMEM_OPTIN
from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
from test_torch_fp32_attn_plan import AttnTf32Prims, _err, _relerr
from test_torch_fp32_ffn_plan import REL_L2
from test_torch_fp32_step_plan import StepPrims
from test_torch_fp32_step_plan import _inputs as _ffn_inputs
from test_torch_fp32_steps import TOL

EPS = 1e-5
LANES = 32


# ------------------------------------------------- the norms' arithmetic

def _lane_groups(c, groups):
    """``[32, 4]``: the group of lane l's channel 4l + j (-1 past C)."""
    ch = torch.arange(4 * LANES).view(LANES, 4)
    return torch.where(ch < c, ch // (c // groups), torch.full_like(ch, -1))


def _group_sums(a, b, c, groups):
    """Per channel its group's sum of a b over ``[N, 32, 4]`` rows.  Groups of
    whole float4s: each lane's partial in channel order, a tree into the
    group's first lane (the lane i + o added to lane i at o = 16, 8, 4, 2, 1
    while both lie in the group), broadcast.  Others: per group each lane's
    partial of its channels there, a butterfly over the lanes (at distance
    16, 8, 4, 2, 1)."""
    grp, dpg, lane = _lane_groups(c, groups), c // groups, torch.arange(LANES)
    prod = a * b
    if dpg % 4 == 0:
        part = torch.zeros_like(prod[..., 0])
        for j in range(4):
            part = part + prod[..., j]
        on = 4 * lane < c
        width = torch.where(on, torch.full_like(lane, dpg // 4), torch.ones_like(lane))
        base = torch.where(on, grp[:, 0] * (dpg // 4), lane)
        i = lane - base
        for o in (16, 8, 4, 2, 1):
            take = i + o < width
            part = torch.where(take, part + part[:, (lane + o).clamp(max=LANES - 1)], part)
        return part[:, base][..., None].expand_as(a)
    out = torch.zeros_like(a)
    for g in range(groups):
        sel = grp == g
        part = torch.zeros_like(prod[..., 0])
        for j in range(4):
            part = part + torch.where(sel[:, j], prod[..., j], torch.zeros(()))
        for o in (16, 8, 4, 2, 1):
            part = part + part[:, lane ^ o]
        out = torch.where(sel, part[..., None], out)
    return out


def _rows(t, npos, c):
    return F.pad(t.reshape(-1)[:npos * c].view(npos, c), (0, 4 * LANES - c)).view(npos, LANES, 4)


def _inv(ss, c, groups, eps):
    """1 / (rms + eps), rms = sqrt(ss) dpg^-1/2, and rms."""
    rms = ss.sqrt() * torch.tensor(float(c // groups)).sqrt().reciprocal()
    return 1 / (rms + eps), rms


def norm_fwd(x, gamma, xn, npos, c, groups, eps):
    """``csrc/step_fp32.cu``'s ``norm_fwd``: xn = x inv gamma."""
    a = _rows(x, npos, c)
    inv, _ = _inv(_group_sums(a, a, c, groups), c, groups, eps)
    out = a * inv * _rows(gamma, 1, c)
    xn.reshape(-1)[:npos * c] = out.view(npos, -1)[:, :c].reshape(-1)


def norm_bwd(x, gamma, dxn, gres, dx, part, npos, c, groups, eps):
    """``norm_bwd``: dx = gamma dxn inv - x coef (+ gres), coef = dot inv^2 /
    (dpg rms), and the dgamma partials of each block of ``S.NP`` positions,
    each warp's ``S.NP / S.NORM_WARPS`` positions summed in order, then the
    block's warps in order."""
    a, d = _rows(x, npos, c), _rows(dxn, npos, c)
    dg = d * _rows(gamma, 1, c)
    inv, rms = _inv(_group_sums(a, a, c, groups), c, groups, eps)
    dot = _group_sums(dg, a, c, groups)
    coef = torch.where(rms > 0, dot * inv * inv / (float(c // groups) * rms), torch.zeros(()))
    out = dg * inv - a * coef
    if gres is not None:
        out = out + _rows(gres, npos, c)
    dx.reshape(-1)[:npos * c] = out.view(npos, -1)[:, :c].reshape(-1)
    blocks, per = -(-npos // S.NP), S.NP // S.NORM_WARPS
    contrib = F.pad((d * a * inv).view(npos, -1), (0, 0, 0, blocks * S.NP - npos))
    contrib = contrib.view(blocks, S.NORM_WARPS, per, -1)
    warps = torch.zeros_like(contrib[:, :, 0])
    for t in range(per):
        warps = warps + contrib[:, :, t]
    acc = torch.zeros_like(warps[:, 0])
    for w in range(S.NORM_WARPS):
        acc = acc + warps[:, w]
    part.copy_(acc[:, :c])


class AttnStepPrims(StepPrims, AttnTf32Prims):
    """The GEMMs of ``csrc/ffn_core_fp32.cu`` (``StepPrims``: ``core_nn`` with
    the output epilogue, ``core_tn``), the attention core of
    ``csrc/attn_fp32.cu`` (``AttnTf32Prims``) and the norms in the kernels'
    order; every call logged in order."""

    def norm_fwd(self, *a):
        self._count("norm_fwd")
        self.log.append(("norm_fwd",))
        norm_fwd(*a)

    def norm_bwd(self, *a):
        self._count("norm_bwd")
        self.log.append(("norm_bwd",))
        norm_bwd(*a)

    def qkv_split(self, *a):
        self.log.append(("qkv_split",))
        super().qkv_split(*a)

    def attn_fwd(self, *a):
        self.log.append(("attn_fwd",))
        super().attn_fwd(*a)

    def attn_bwd(self, *a):
        self.log.append(("attn_bwd",))
        super().attn_bwd(*a)


def _attn_inputs(seed, r, seq, c, a):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((r, seq, c))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    w_qkv = ((rng.random((3 * a, c)) * 2 - 1) * 2 * c ** -0.5).astype(np.float32)
    w_out = ((rng.random((c, a)) * 2 - 1) * a ** -0.5).astype(np.float32)
    g = rng.standard_normal((r, seq, c)).astype(np.float32)
    return [torch.from_numpy(t) for t in (x, gamma, w_qkv, w_out, g)]


def _check(out, ref_out, grads, ref_grads):
    """The output and dx within ``TOL`` of max|ref|, dgamma and the weight
    gradients within ``REL_L2``."""
    assert _err(out, ref_out) <= TOL, ("out", _err(out, ref_out))
    assert _err(grads[0], ref_grads[0]) <= TOL, ("dx", _err(grads[0], ref_grads[0]))
    for name, got, want in zip(("dgamma", "dw_qkv", "dw_out"), grads[1:], ref_grads[1:]):
        assert tuple(got.shape) == tuple(np.shape(want)), name
        assert _relerr(got, want) <= REL_L2, (name, _relerr(got, want))


# ------------------------------------------------ the chain against JAX

# (rows, L, C, heads, norm groups, residual), A = C: the 65-position tail of
# the 64-row tiles and L 1, C 32 / 64, H 2 / 4, one and two groups, the
# partial-sum mode; two JAX runs a case (forward with the stash, backward)
JAX_CASES = [(2, 65, 32, 2, 1, True), (3, 1, 64, 4, 2, False)]


@pytest.mark.parametrize("r,seq,c,h,groups,residual", JAX_CASES)
def test_emulated_attention_step_matches_jax(r, seq, c, h, groups, residual):
    x, gamma, w_qkv, w_out, g = _attn_inputs(seq + c, r, seq, c, c)
    jargs = [jnp.asarray(t.numpy()) for t in (x, gamma, w_qkv, w_out)]
    with pltpu.force_tpu_interpret_mode():
        want, o_stash, stats = JAB._attn_forward(*jargs, h, groups, EPS, True, 10000.0, 0.0,
                                                 None, return_o=True, residual=residual)
        wgrads = JAB._attn_backward_pallas(*jargs, h, groups, EPS, True, 10000.0, 0.0, None,
                                           jnp.asarray(g.numpy()), o_stash, stats,
                                           residual=residual)
    prims = AttnStepPrims()
    args = (h, groups, EPS, True, 10000.0, 0.0, 0, 0, residual)
    out, stash = S.attention_forward(x, gamma, w_qkv, w_out, *args, stash=True, prims=prims)
    grads = S.attention_backward(g, x, gamma, w_qkv, w_out, stash, *args, prims=prims)
    _check(out, np.asarray(want), grads, [np.asarray(t) for t in wgrads])
    assert prims.calls["attn_fwd"] == prims.calls["attn_bwd"] == 1


@pytest.mark.parametrize("residual", [True, False])
def test_emulated_attention_step_with_dropout(residual):
    """Both dropout sites (the probability mask and, with a residual, the
    projection's) at rows offset by 5, against autograd through the plain
    version, whose masks are the kernels' bits."""
    r, seq, c, h, groups = 3, 17, 64, 4, 2
    x, gamma, w_qkv, w_out, g = _attn_inputs(7, r, seq, c, c)
    args = (h, groups, EPS, True, 10000.0, 0.1, 4321, 5, residual)
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, w_qkv, w_out)]
    ref = AB.reference_attention_block(*leaves, *args)
    ref_grads = [t.detach() for t in torch.autograd.grad(ref, leaves, g)]
    prims = AttnStepPrims()
    out, stash = S.attention_forward(x, gamma, w_qkv, w_out, *args, stash=True, prims=prims)
    grads = S.attention_backward(g, x, gamma, w_qkv, w_out, stash, *args, prims=prims)
    _check(out, ref.detach(), grads, ref_grads)
    assert (("mask_rows",) in prims.log) == residual


# ------------------------------------------------------------ the chain

@pytest.mark.parametrize("residual", [True, False])
def test_emulated_attention_chain_is_the_wrappers_calls(residual):
    """Forward: the norm, QKV (``core_nn``, store, N 3A), the RoPE split, the
    core, the out-projection (``core_nn``, output epilogue, N C).  Backward:
    the projection mask on g (with a residual and dropout), do (``core_nn``,
    store, N A), the core's backward, the norm again, dxn (``core_nn``,
    store, K 3A), the norm's backward, the two weight products
    (``core_tn``), then the fixed-order sums of dgamma, dW_qkv and dW_out.
    At the base widths (C = A = 96) the QKV product takes the 64-wide tile
    (288 = 4.5 x 64), the others the 96-wide one."""
    r, seq, c, a, h = 2, 6, 96, 96, 4
    x, gamma, w_qkv, w_out, g = _attn_inputs(3, r, seq, c, a)
    args = (h, 4, EPS, True, 10000.0, 0.1, 3, 0, residual)
    prims = AttnStepPrims()
    _, stash = S.attention_forward(x, gamma, w_qkv, w_out, *args, stash=True, prims=prims)
    npos = r * seq
    assert prims.log == [("norm_fwd",), ("core_nn", S.EPI_STORE, npos, c, 3 * a),
                         ("qkv_split",), ("attn_fwd",), ("core_nn", S.EPI_OUT, npos, a, c)]
    assert prims.tiles == [64, 96]
    prims.log.clear()
    S.attention_backward(g, x, gamma, w_qkv, w_out, stash, *args, prims=prims)
    so, sq = U._tn_splits(c, a, npos), U._tn_splits(3 * a, c, npos)
    want = [("mask_rows",)] if residual else []
    want += [("core_nn", S.EPI_STORE, npos, c, a), ("attn_bwd",), ("norm_fwd",),
             ("core_nn", S.EPI_STORE, npos, 3 * a, c), ("norm_bwd",),
             ("core_tn", c, a, npos, so), ("core_tn", 3 * a, c, npos, sq)] + [("reduce",)] * 3
    assert prims.log == want
    assert prims.tiles[2:] == [96, 96]


class CardPrims(S.CudaPrims):
    """The card's prims with no library: the GEMMs an FFMA kernel would take
    refuse, the norms, masks, sums and the attention core run on an
    emulation (logged there)."""

    def __init__(self):
        self.emu = AttnStepPrims()

    def gemm_nn(self, *a, **kw):
        raise AssertionError("an FFMA gemm_nn ran in an fp32 step")

    def gemm_tn(self, *a, **kw):
        raise AssertionError("an FFMA gemm_tn ran in an fp32 step")


for _name in ("norm_fwd", "norm_bwd", "mask_rows", "reduce", "qkv_split", "attn_fwd",
              "attn_bwd"):
    setattr(CardPrims, _name, lambda self, *a, _n=_name: getattr(self.emu, _n)(*a))


def test_card_prims_run_no_ffma_gemm_in_any_step(monkeypatch):
    """``step_fp32.CudaPrims`` has no FFMA GEMM left, and on the card's prims
    every GEMM of #2-#5 goes to ``unfused_fp32.CorePrims`` (here an
    emulation in its place): the FFN step's conv, deconv, dh, dx and weight
    products, the attention step's QKV, out-projection, do, dxn and weight
    products.  The results are the emulated chain's, bit for bit."""
    assert not any(hasattr(S.CudaPrims, n) for n in ("gemm_nn", "gemm_tn"))
    card, core = CardPrims(), AttnStepPrims()
    monkeypatch.setattr(S, "_CUDA", [card])
    monkeypatch.setattr(U, "_CORE", [core])
    rng = np.random.default_rng(5)
    fx, fgamma, fw, fg = _ffn_inputs(rng, 2, 9, 32, 64, 4)
    fx, fgamma, fg = map(torch.from_numpy, (fx, fgamma, fg))
    fw = [torch.from_numpy(w) for w in fw]
    fargs = (4, 2, EPS, 0.1, 8, 1, True)
    x, gamma, w_qkv, w_out, g = _attn_inputs(11, 2, 9, 32, 32)
    aargs = (2, 2, EPS, True, 10000.0, 0.1, 8, 1, True)

    def run(prims=None):
        kw = {} if prims is None else {"prims": prims}
        out = [S.ffn_forward(fx, fgamma, *fw, *fargs, **kw)]
        out += S.ffn_backward(fg, fx, fgamma, *fw[:3], *fargs, **kw)
        o, stash = S.attention_forward(x, gamma, w_qkv, w_out, *aargs, stash=True, **kw)
        return out + [o] + list(S.attention_backward(g, x, gamma, w_qkv, w_out, stash, *aargs,
                                                     **kw))
    got = run()
    kinds = [e[0] for e in core.log]
    assert set(kinds) == {"core_nn", "core_tn", "colsum"}
    assert kinds.count("core_nn") == 2 + 3 + 2 + 2 and kinds.count("core_tn") == 2 + 2
    assert not any(e[0].startswith("core") or e[0] == "colsum" for e in card.emu.log)
    again = run(AttnStepPrims())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# ------------------------------------------------------------ the norms

# (C, groups): every width the gates admit, one to four groups, and groups
# that straddle a lane's float4 (C 96 / 32 groups: 3 channels each; C 32 /
# 16: 2)
NORM_CASES = [(32, 1), (32, 16), (64, 2), (96, 4), (96, 32), (128, 4), (128, 1)]


@pytest.mark.parametrize("c,groups", NORM_CASES)
def test_norms_in_the_kernels_order_match_the_plain_norm(c, groups):
    """The norms as the kernels sum them against ``rms_group_norm`` and its
    autograd (with the residual's gradient added), within ``TOL`` of
    max|ref|; the dgamma partials (one row per ``S.NP`` positions, the last
    block ragged) sum to dgamma within ``REL_L2``."""
    npos = 3 * S.NP + 5
    gen = torch.Generator().manual_seed(c + groups)
    x = torch.randn(npos, c, generator=gen) * 0.5
    gamma = 1 + 0.1 * torch.randn(c, generator=gen)
    dxn, gres = torch.randn(npos, c, generator=gen), torch.randn(npos, c, generator=gen)
    xn = torch.empty(npos, c)
    norm_fwd(x, gamma, xn, npos, c, groups, EPS)
    xl, gl = x.clone().requires_grad_(True), gamma.clone().requires_grad_(True)
    ref = rms_group_norm(xl, gl, groups, EPS)
    ref_dx, ref_dg = torch.autograd.grad(ref, (xl, gl), dxn)
    assert _err(xn, ref.detach()) <= TOL
    dx, part = torch.empty(npos, c), torch.empty(-(-npos // S.NP), c)
    norm_bwd(x, gamma, dxn, gres, dx, part, npos, c, groups, EPS)
    assert _err(dx, ref_dx + gres) <= TOL
    assert _relerr(part.sum(0), ref_dg) <= REL_L2


# ----------------------------------------------------------------- gates

def test_attention_gate_layouts():
    """The fp32 attention step's layouts: ``core_nn`` at each GEMM's tile
    (the QKV product 64 wide at A 96, 128 at A 128; the out-projection and
    dxn 96 wide at C 96; do's N = A; the mp 4 shard's A 24: QKV N 72, do N
    24), ``core_tn``, the core's at DP 32 and the norm backward's partials
    (a row of C floats a warp, 8 warps); every width the gate admits fits,
    in eval and training; and the norm blocks' positions (4 a warp)."""
    core, attn = U.core_launch_bytes(), S.attn_launch_bytes(S.DP)
    nn = lambda n: core[U.NN_KEY[U.core_tile(n)]]
    for c, a, h in ((96, 96, 4), (128, 128, 4), (96, 24, 1), (32, 32, 2), (64, 48, 2)):
        want = {"qkv": nn(3 * a), "attn": attn["attn"], "proj": nn(c)}
        assert S.launch_bytes(c, a) == want
        want.update(dout=nn(a), dkdv=attn["dkdv"], dxn=nn(c), tn=core["tn"], norm_bwd=32 * c)
        assert S.launch_bytes(c, a, True) == want
        assert S.supports_attention(c, a, h, True)
    assert [U.core_tile(n) for n in (288, 384, 72, 24, 96)] == [64, 128, 128, 64, 96]
    assert (S.NP, S.NORM_WARPS) == (32, 8)
    for c in S.CHANNELS:
        for a in range(8, 4 * c + 1, 8):
            for training in (False, True):
                assert max(S.launch_bytes(c, a, training).values()) <= SMEM_OPTIN
