"""The fp32 FFN step's kernels (#2 forward, #5 backward at fp32) on the CPU.

Since the 3xTF32 redesign, ``ops/cuda/step_fp32.py``'s ``ffn_forward`` /
``ffn_backward`` run their GEMMs on ``csrc/ffn_core_fp32.cu`` (the unfused
FFN core's kernels: ``core_nn`` with the step's output epilogue and an n96
tile, ``core_tn``, ``core_colsum``) between ``csrc/step_fp32.cu``'s norms,
outer mask and fixed-order reductions.  Those run on the card only, so
their arithmetic is emulated here in plain torch (:class:`StepPrims`, which
adds the output epilogue to ``tests/test_torch_fp32_ffn_plan.py``'s
``Tf32Prims``: bias, the outer mask at (row, position, channel), residual;
with no residual the products alone):

* the emulated chain against the JAX package's ``fused_norm_ffn_residual``
  and its Pallas ``_blk_backward`` in interpret mode at fp32 rows and
  dropout 0 (C 32 / 64, I 64, k 4 / 8, L 1 / 17 / 65, one and two norm
  groups, the residual and the partial-sum mode), within the fp32
  tolerances of ``test_torch_fp32_steps.py`` (``TOL``) and
  ``test_torch_fp32_ffn_plan.py`` (``REL_L2``);
* at dropout 0.1, in row groups of one at a row offset, against autograd
  through the port's plain version;
* the chain call for call, and on the card's prims no FFMA GEMM;
* the gate's layouts (``core_nn`` at each GEMM's tile, 96 at C 96).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.ops.pallas import swiglu_block as JB
from mss_tf_locoformer_tpu_torch.ops.cuda import SMEM_OPTIN
from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
from test_torch_fp32_ffn_plan import REL_L2, Tf32Prims, three_pass
from test_torch_fp32_steps import TOL, _keep, _win

EPS = 1e-5
NAMES = ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b")


class StepPrims(Tf32Prims):
    """``Tf32Prims`` with the FFN step's output epilogue and the tile each
    ``core_nn`` call takes (``tiles``); the norms, the outer mask and the
    reductions as ``TorchPrims`` runs them, logged in order with the GEMMs."""

    def __init__(self):
        super().__init__()
        self.tiles = []

    def gemm_nn(self, epi, a, m, k, b, n, out, ldo, bias=None, y=None, res=None, p=1,
                site=0, drop=(0, 0, 0, 1.0, 0)):
        self.tiles.append(U.core_tile(n))
        if epi != S.EPI_OUT:
            return super().gemm_nn(epi, a, m, k, b, n, out, ldo, bias=bias, y=y, res=res, p=p,
                                   site=site, drop=drop)
        hi, lo = U.panel_halves(b, k, n)
        self.log.append(("core_nn", epi, m, k, n))
        v = three_pass(_win(a, m, k), b, (hi.T, lo.T))
        if res is not None:   # else the partial sum alone: no bias, no mask
            v = v + (0 if bias is None else bias)
            if drop[4]:
                q = torch.arange(m)
                keep = _keep(drop, site, (q // p)[:, None], (q % p)[:, None],
                             torch.arange(n)[None])
                v = torch.where(keep, v * drop[3], torch.zeros(()))
            v = v + res.reshape(m, n)
        out.reshape(-1)[:m * ldo].view(m, ldo)[:, :n] = v

    def norm_fwd(self, *a):
        self.log.append(("norm_fwd",))
        super().norm_fwd(*a)

    def norm_bwd(self, *a):
        self.log.append(("norm_bwd",))
        super().norm_bwd(*a)

    def mask_rows(self, *a):
        self.log.append(("mask_rows",))
        super().mask_rows(*a)

    def reduce(self, *a):
        self.log.append(("reduce",))
        super().reduce(*a)


def _inputs(rng, r, seq, c, inner, k):
    x = (0.5 * rng.standard_normal((r, seq, c))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bound = (c * k) ** -0.5
    w = [rng.uniform(-bound, bound, s).astype(np.float32)
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    g = rng.standard_normal((r, seq, c)).astype(np.float32)
    return x, gamma, w, g


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL:g} x {scale:.3e}"


def _rel(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not np.abs(ref).max():
        assert not np.abs(got).max(), what
        return
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= REL_L2, f"{what}: relative L2 {rel:.3e}"


def _check(out, ref_out, got, ref, residual=True):
    """Outputs and dx within ``TOL`` of max|ref|, the other gradients within
    ``REL_L2``; in the partial-sum mode the deconv bias's gradient is the
    caller's (the step gives zeros)."""
    _close(out, ref_out, "out")
    for name, a, b in zip(NAMES, got, ref):
        assert tuple(a.shape) == tuple(np.shape(b)), name
        if name == "ddeconv_b" and not residual:
            assert not a.any(), name
            continue
        (_close if name == "dx" else _rel)(a, b, name)


# ------------------------------------------------ the chain against JAX

# (rows, L, C, I, k, norm groups, residual): L 1 / 17 / 65, C 32 / 64, k 4 /
# 8, one and two groups, the partial-sum mode
CASES = [(2, 17, 32, 64, 4, 1, True), (2, 1, 64, 64, 8, 2, True), (1, 65, 32, 64, 8, 2, False),
         (3, 17, 64, 64, 4, 1, False)]


@pytest.mark.parametrize("r,seq,c,inner,k,groups,residual", CASES)
def test_emulated_step_matches_jax(rng, r, seq, c, inner, k, groups, residual):
    x, gamma, w, g = _inputs(rng, r, seq, c, inner, k)
    args = (k, groups, EPS, 0.0, 0, 0, residual)
    prims = StepPrims()
    db = _t(w[3]) if residual else None   # the partial-sum step takes no deconv bias
    out = S.ffn_forward(_t(x), _t(gamma), *map(_t, w[:3]), db, *args, prims=prims)
    got = S.ffn_backward(_t(g), _t(x), _t(gamma), *map(_t, w[:3]), *args, prims=prims)
    jargs = [jnp.asarray(a) for a in (x, gamma, *w[:3], w[3] if residual else 0 * w[3])]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JB.fused_norm_ffn_residual(*jargs, k, groups, EPS,
                                                     residual=residual))
        wgrads = JB._blk_backward(*jargs, k, groups, EPS, 0.0, None, jnp.asarray(g), residual)
    _check(out, want, got, [np.asarray(a) for a in wgrads], residual)


@pytest.mark.parametrize("residual", [True, False])
def test_emulated_step_with_dropout_in_row_groups(rng, residual):
    """Both dropout sites at their coordinates (rows offset by 5), rows in
    groups of one, against autograd through the plain version."""
    r, seq, c, inner, k, groups, p = 3, 17, 32, 64, 4, 2, 0.1
    x, gamma, w, g = _inputs(rng, r, seq, c, inner, k)
    args = (k, groups, EPS, p, 99, 5, residual)
    params = [_t(a).requires_grad_(True) for a in (gamma, *w[:3])]
    db = _t(w[3]).requires_grad_(True) if residual else None
    xt = _t(x).requires_grad_(True)
    ref_out = FB.reference_norm_ffn_residual(xt, *params, db, *args)
    leaves = [xt, *params] + ([db] if residual else [])
    ref = list(torch.autograd.grad(ref_out, leaves, _t(g)))
    if not residual:
        ref.append(torch.zeros(c))
    assert S.ffn_rows(r, seq, c, inner, k, True, 1) == 1
    prims = StepPrims()
    out = S.ffn_forward(_t(x), _t(gamma), *map(_t, w[:3]), None if db is None else _t(w[3]),
                        *args, prims=prims, scratch_cap=1)
    got = S.ffn_backward(_t(g), _t(x), _t(gamma), *map(_t, w[:3]), *args, prims=prims,
                         scratch_cap=1)
    _check(out, ref_out.detach(), got, [t.detach() for t in ref])
    assert ("mask_rows",) in prims.log if residual else ("mask_rows",) not in prims.log


# ------------------------------------------------------------ the chain

@pytest.mark.parametrize("residual", [True, False])
def test_emulated_chain_is_the_wrappers_calls(rng, residual):
    """Per row group, forward: the norm, the conv (``core_nn``, SwiGLU
    epilogue) and the deconv (``core_nn``, output epilogue); backward: the
    norm and the conv again, the outer mask on g (with a residual and
    dropout), dh (``core_nn``, SwiGLU backward), dx (``core_nn``, store),
    the norm's backward, the two weight products (``core_tn``) with their
    column sums (``core_colsum``; the deconv bias's only with a residual);
    then the fixed-order reductions.  The forward's three rows fit one
    group, the backward's take two (2 and 1).  C 96's deconv and dx take the
    96-wide tile; the conv (2I 768) and dh (I 384) the 128-wide one."""
    r, seq, c, inner, k = 3, 6, 96, 384, 4
    x, gamma, w, g = _inputs(rng, r, seq, c, inner, k)
    lc = seq + k - 1
    args = (k, 4, EPS, 0.1, 3, 0, residual)
    cap = 4 * 2 * (3 * seq * c + 5 * lc * inner)    # two rows a group: groups of 2 and 1
    assert S.ffn_rows(r, seq, c, inner, k, True, cap) == 2
    prims = StepPrims()
    S.ffn_forward(_t(x), _t(gamma), *map(_t, w[:3]), _t(w[3]) if residual else None, *args,
                  prims=prims, scratch_cap=cap)
    assert prims.tiles == [128, 96]
    S.ffn_backward(_t(g), _t(x), _t(gamma), *map(_t, w[:3]), *args, prims=prims,
                   scratch_cap=cap)
    assert prims.tiles[2:] == [128, 128, 96] * 2
    s1, s2 = U._tn_splits(2 * inner, k * c, 2 * lc), U._tn_splits(inner, k * c, 2 * lc)
    sb, sdb = S._col_splits(2 * lc), S._col_splits(2 * seq)
    want = [("norm_fwd",), ("core_nn", S.EPI_SWIGLU, r * lc, k * c, 2 * inner),
            ("core_nn", S.EPI_OUT, r * seq, k * inner, c)]
    for n in (2, 1):
        want += [("norm_fwd",), ("core_nn", S.EPI_SWIGLU, n * lc, k * c, 2 * inner)]
        want += [("mask_rows",)] if residual else []
        want += [("core_nn", S.EPI_SWIGLU_BWD, n * lc, k * c, inner),
                 ("core_nn", S.EPI_STORE, n * seq, k * 2 * inner, c), ("norm_bwd",),
                 ("core_tn", 2 * inner, k * c, n * lc, s1), ("colsum", 2 * inner, n * lc, sb),
                 ("core_tn", inner, k * c, n * lc, s2)]
        want += [("colsum", c, n * seq, sdb)] if residual else []
    # dconv_w, dconv_b, ddeconv_w, (ddeconv_b,) dgamma: <= 256 partials each
    want += [("reduce",)] * (5 if residual else 4)
    assert prims.log == want


class CardPrims(S.CudaPrims):
    """The card's prims with no library: the FFMA GEMMs refuse, the norms,
    the mask and the reductions run on an emulation."""

    def __init__(self):
        self.emu = StepPrims()

    def gemm_nn(self, *a, **kw):
        raise AssertionError("an FFMA gemm_nn ran in an FFN step")

    def gemm_tn(self, *a, **kw):
        raise AssertionError("an FFMA gemm_tn ran in an FFN step")

    def norm_fwd(self, *a):
        self.emu.norm_fwd(*a)

    def norm_bwd(self, *a):
        self.emu.norm_bwd(*a)

    def mask_rows(self, *a):
        self.emu.mask_rows(*a)

    def reduce(self, *a):
        self.emu.reduce(*a)


def test_card_prims_run_no_ffma_gemm(rng, monkeypatch):
    """On the card's prims (``step_fp32.CudaPrims``) the FFN step's GEMMs go
    to ``unfused_fp32.CorePrims`` (here an emulation in its place) and none
    to the FFMA ``gemm_nn`` / ``gemm_tn``; the results are the emulated
    chain's."""
    r, seq, c, inner, k = 2, 9, 32, 64, 4
    x, gamma, w, g = _inputs(rng, r, seq, c, inner, k)
    args = (k, 2, EPS, 0.1, 8, 1, True)
    card, core = CardPrims(), StepPrims()
    monkeypatch.setattr(S, "_CUDA", [card])
    monkeypatch.setattr(U, "_CORE", [core])
    out = S.ffn_forward(_t(x), _t(gamma), *map(_t, w), *args)
    got = S.ffn_backward(_t(g), _t(x), _t(gamma), *map(_t, w[:3]), *args)
    gemms = [e for e in core.log if e[0] in ("core_nn", "core_tn", "colsum")]
    assert len(gemms) == 2 + 7 and len(core.log) == len(gemms)
    assert [e[0] for e in card.emu.log] == ["norm_fwd", "norm_fwd", "mask_rows", "norm_bwd"] + \
        ["reduce"] * 5
    emu = StepPrims()
    assert torch.equal(out, S.ffn_forward(_t(x), _t(gamma), *map(_t, w), *args, prims=emu))
    again = S.ffn_backward(_t(g), _t(x), _t(gamma), *map(_t, w[:3]), *args, prims=emu)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# ----------------------------------------------------------------- gates

def test_fp32_step_layouts_and_tiles():
    """``core_nn``'s tile at each output width (96 at 96 only; C 32 / 64 /
    128 keep theirs), and the FFN step's layouts at the base (C 96, I 384)
    and speech (C 128, I 384) widths, pinned (the compiled kernels' own
    count on the card); every width and inner size the gate admits fits."""
    assert {n: U.core_tile(n) for n in (32, 48, 64, 96, 128, 192, 256, 384, 768)} == \
        {32: 64, 48: 64, 64: 64, 96: 96, 128: 128, 192: 64, 256: 128, 384: 128, 768: 128}
    nn128, nn96, nn64, tn = 197632, 164864, 132096, 104448
    assert U.core_launch_bytes() == {"nn": nn128, "nn64": nn64, "tn": tn, "nn96": nn96}
    assert S.ffn_launch_bytes(96, 384) == {"conv": nn128, "deconv": nn96}
    assert S.ffn_launch_bytes(96, 384, True) == {"conv": nn128, "deconv": nn96, "dh": nn128,
                                                 "dx": nn96, "tn": tn, "norm_bwd": 3072}
    assert S.ffn_launch_bytes(128, 384, True) == {"conv": nn128, "deconv": nn128, "dh": nn128,
                                                  "dx": nn128, "tn": tn, "norm_bwd": 4096}
    assert S.ffn_launch_bytes(32, 64, True) == {"conv": nn128, "deconv": nn64, "dh": nn64,
                                                "dx": nn64, "tn": tn, "norm_bwd": 1024}
    for c in S.CHANNELS:
        for inner in range(4, 4100, 4):
            assert S.supports_ffn(c, inner, 4, True)
            assert max(S.ffn_launch_bytes(c, inner, True).values()) <= SMEM_OPTIN
