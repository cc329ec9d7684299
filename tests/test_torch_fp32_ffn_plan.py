"""The 3xTF32 FFN-core kernels' arithmetic (#8 forward, #9 backward at fp32)
on the CPU.

``csrc/ffn_core_fp32.cu`` runs on the card only, so its arithmetic is
emulated here in plain torch (:class:`Tf32Prims`), from the panels the
wrapper lays out and the chain of calls it makes (``ops/cuda/
unfused_fp32.py``):

* an operand splits into TF32 halves by round-to-nearest on its int32 bit
  pattern (ties away from zero, as ``cvt.rna``): hi, then the remainder
  rounded the same way; the weight panels hold theirs from
  :func:`unfused_fp32.core_panels`, K-major, while A is split as the
  kernels read it into registers;
* per k8 step (8 taps x channels of a window in ``core_nn``, 8 positions in
  ``core_tn``) three products summed in fp32, the small ones first:
  lo hi', hi lo', hi hi' (the kernels add each 32-deep stage's products
  into an fp32 sum, since the tensor cores truncate as they add; no
  emulation reproduces that truncation, so the sums here are fp32 at every
  step);
* the epilogues (SwiGLU with the inner mask, its backward, the store) and
  the column sums and fixed-order reductions as ``TorchPrims`` runs them.

The emulated chain is held against the JAX package's ``swiglu_conv_deconv``
and ``_backward_pallas`` in interpret mode (tests/test_torch_fp32_steps.py's
``TOL``; the weight gradients by relative L2), and against the port's plain
version at dropout 0.1 in row groups.  One TF32 pass misses that tolerance;
three meet it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.ops.pallas import swiglu_ffn as JFFN
from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
from test_torch_fp32_steps import TOL, TorchPrims, _win

REL_L2 = 1e-4     # weight gradients: sums over every position in another order
NAMES = ("dx", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b")


def rna(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to nearest TF32, ties away from zero: half the weight of
    the 13 dropped bits added to the bit pattern's magnitude, then dropped."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def split(t: torch.Tensor):
    hi = rna(t)
    return hi, rna(t - hi)


def three_pass(a: torch.Tensor, b: torch.Tensor, b_halves=None) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` as the kernels sum it: per k8 step lo hi', hi
    lo', hi hi' in fp32 (K zero-padded to whole steps)."""
    pad = -a.shape[1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    ahi, alo = split(a)
    bhi, blo = b_halves if b_halves is not None else split(b)
    bhi, blo = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (bhi, blo))
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        acc = acc + alo[:, s] @ bhi[s]
        acc = acc + ahi[:, s] @ blo[s]
        acc = acc + ahi[:, s] @ bhi[s]
    return acc


class Tf32Prims(TorchPrims):
    """The kernels of ``csrc/ffn_core_fp32.cu`` in plain torch, with
    ``CorePrims``' conventions (``gemm_nn`` takes a ``split_panel`` view and
    reads its halves; ``gemm_tn`` splits both operands); ``colsum`` and
    ``reduce`` as ``TorchPrims``.  Records each call's kernel and sizes."""

    def __init__(self):
        super().__init__()
        self.log = []

    def gemm_nn(self, epi, a, m, k, b, n, out, ldo, bias=None, y=None, res=None, p=1,
                site=0, drop=(0, 0, 0, 1.0, 0)):
        assert res is None and epi in (S.EPI_STORE, S.EPI_SWIGLU, S.EPI_SWIGLU_BWD)
        hi, lo = U.panel_halves(b, k, n)
        # the panel's halves are b's own split, K-major
        assert torch.equal(hi.T, split(b)[0]) and torch.equal(lo.T, split(b)[1])
        self.log.append(("core_nn", epi, m, k, n))
        acc = three_pass(_win(a, m, k), b, (hi.T, lo.T))
        # the accumulator through TorchPrims' epilogues: an identity B passes
        # it exactly (every other product is 0)
        super().gemm_nn(epi, S._dense(acc, m, n), m, n, torch.eye(n), n, out, ldo, bias=bias,
                        y=y, p=p, site=site, drop=drop)

    def gemm_tn(self, a, m, b, n, total, splits, part):
        self._count("gemm_tn")
        self.log.append(("core_tn", m, n, total, splits))
        aw, bw = _win(a, total, m), _win(b, total, n)
        per = -(-total // splits)
        for s in range(splits):
            part[s] = three_pass(aw[s * per:(s + 1) * per].T, bw[s * per:(s + 1) * per])

    def colsum(self, a, w, total, splits, part):
        self.log.append(("colsum", w, total, splits))
        super().colsum(a, w, total, splits, part)


def _inputs(rng, r, seq, c, inner, k):
    lin = seq + 2 * (k - 1)
    x = np.zeros((r, lin, c), np.float32)            # pre-padded rows
    x[:, k - 1:k - 1 + seq] = rng.standard_normal((r, seq, c))
    bound = (c * k) ** -0.5
    w = [rng.uniform(-bound, bound, s).astype(np.float32)
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    g = rng.standard_normal((r, lin, c)).astype(np.float32)
    return x, w, g


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _rel(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= REL_L2, f"{what}: relative L2 {rel:.3e}"


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


# ------------------------------------------------------------ the split

def test_split_reconstructs_fp32_operands(rng):
    """hi + lo is an fp32 operand to 2^-21 of its magnitude; both halves are
    TF32 (low 13 bits zero); hi is the nearest TF32 (ties away from zero);
    the package's split is this one."""
    t = _t(rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096)))
    hi, lo = split(t)
    assert ((hi + lo - t).abs() <= 2.0 ** -21 * t.abs()).all()
    for h in (hi, lo):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    assert ((t - hi).abs() <= 2.0 ** -11 * t.abs()).all()
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11])
    assert rna(ties).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -9]
    got = U.tf32_split(t)
    assert torch.equal(got[0], hi) and torch.equal(got[1], lo)


def test_three_passes_meet_the_tolerance_one_does_not(rng):
    """At K 1024: three TF32 passes stay within ``TOL`` of the float64
    product, as fp32 does; one pass on the rounded operands misses it."""
    a, b = _t(rng.standard_normal((64, 1024))), _t(rng.standard_normal((1024, 64)))
    ref = (a.double() @ b.double()).numpy()
    _close(three_pass(a, b), ref, "3xTF32")
    one = (rna(a) @ rna(b)).numpy()
    assert np.abs(one - ref).max() > TOL * np.abs(ref).max()


def test_core_panels_are_split_and_k_major(rng):
    """Each GEMM panel of :func:`unfused_fp32.core_panels` is the ``[K, N]``
    view of a ``[3, N, K]`` tensor (the panel K-major, its hi and lo), with
    the values of ``step_fp32.ffn_panels``; the inner width padded to whole
    float4s."""
    c, inner, k = 12, 30, 3
    _, w, _ = _inputs(rng, 1, 4, c, inner, k)
    panels = U.core_panels(*map(_t, w[:3]))
    ip = 32
    wpad = [_t(np.pad(w[0].reshape(2, inner, c, k), ((0, 0), (0, 2), (0, 0), (0, 0)))
               .reshape(2 * ip, c, k)), _t(np.pad(w[1].reshape(2, inner), ((0, 0), (0, 2)))
                                          .reshape(-1)), _t(np.pad(w[2], ((0, 2), (0, 0), (0, 0))))]
    want = S.ffn_panels(*wpad)
    assert torch.equal(panels[1], want[1])
    for got, ref in zip(panels[:1] + panels[2:], want[:1] + want[2:]):
        kk, n = ref.shape
        assert torch.equal(got, ref)
        base = got._base
        assert base.shape == (3, n, kk) and base.is_contiguous()
        assert torch.equal(base[0], ref.T)
        hi, lo = U.panel_halves(got, kk, n)
        assert torch.equal(hi, split(ref.T)[0]) and torch.equal(lo, split(ref.T)[1])
    with pytest.raises(ValueError):
        U.panel_halves(want[0], *want[0].shape)
    with torch.inference_mode():   # serving: its views keep no _base
        view = U.split_panel(want[0])
        assert view._base is None
        hi, lo = U.panel_halves(view, *want[0].shape)
        assert torch.equal(hi, split(want[0].T)[0]) and torch.equal(lo, split(want[0].T)[1])


# ------------------------------------------------ the chain against JAX

# (rows, L, C, I, k): C 4 / 48 / 64, inner 30 (padded to 32) / 64, k 4 / 8,
# L 1 / 65 / 129
CASES = [(2, 65, 4, 30, 4), (1, 129, 48, 64, 8), (2, 1, 64, 30, 4), (1, 65, 64, 64, 8),
         (2, 1, 4, 64, 8)]


@pytest.mark.parametrize("r,seq,c,inner,k", CASES)
def test_emulated_kernels_match_jax(rng, r, seq, c, inner, k):
    x, w, g = _inputs(rng, r, seq, c, inner, k)
    prims = Tf32Prims()
    out = U.ffn_core_fp32(_t(x), *map(_t, w), k, prims=prims)
    grads = U.ffn_core_fp32_backward(_t(g), _t(x), *map(_t, w[:3]), k, prims=prims)
    jargs = [jnp.asarray(a) for a in (x, *w)]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JFFN.swiglu_conv_deconv(*jargs, k))
        wgrads = JFFN._backward_pallas(*jargs, k, jnp.asarray(g))
    _close(out, want, "out")
    for name, a, wg in zip(NAMES, grads, wgrads):
        assert a.shape == np.shape(wg), name
        (_close if name == "dx" else _rel)(a, np.asarray(wg), name)


def test_emulated_kernels_with_dropout_in_row_groups(rng):
    """The inner mask at ``inner_mask``'s coordinates (rows offset by 5),
    rows in groups of one, against autograd through the plain version."""
    r, seq, c, inner, k, p = 3, 17, 48, 30, 4, 0.1
    x, w, g = _inputs(rng, r, seq, c, inner, k)
    leaves = [_t(a).requires_grad_(True) for a in (x, *w)]
    ref_out = SF.reference_swiglu_conv_deconv(*leaves, k, p, 99, 5)
    ref = torch.autograd.grad(ref_out, leaves, _t(g))
    prims = Tf32Prims()
    out = U.ffn_core_fp32(_t(x), *map(_t, w), k, p, 99, 5, prims=prims, scratch_cap=1)
    got = U.ffn_core_fp32_backward(_t(g), _t(x), *map(_t, w[:3]), k, p, 99, 5, prims=prims,
                                   scratch_cap=1)
    _close(out, ref_out.detach(), "out")
    for name, a, b in zip(NAMES, got, ref):
        (_close if name == "dx" else _rel)(a, b, name)


def test_emulated_chain_is_the_wrappers_calls(rng):
    """The chain the design lays out, call for call, is what the wrapper
    asks of its prims: per row group the conv (SwiGLU epilogue) and the
    deconv (store) forward; the conv again, dh (SwiGLU backward), dx
    (store), and the two weight products with their column sums backward;
    then the fixed-order reductions.  The card's prims give the core's
    GEMMs to ``CorePrims``; an emulation keeps them."""
    r, seq, c, inner, k = 3, 6, 8, 12, 3
    x, w, g = _inputs(rng, r, seq, c, inner, k)
    lin, lc, ip = seq + 2 * (k - 1), seq + k - 1, 12
    cap = 4 * 5 * lc * ip * 2                    # two rows a group: groups of 2 and 1
    prims = Tf32Prims()
    U.ffn_core_fp32(_t(x), *map(_t, w), k, prims=prims, scratch_cap=4 * lc * ip * 2)
    U.ffn_core_fp32_backward(_t(g), _t(x), *map(_t, w[:3]), k, prims=prims, scratch_cap=cap)
    s1, s2 = U._tn_splits(2 * ip, k * c, 2 * lc), U._tn_splits(ip, k * c, 2 * lc)
    sb, sdb = S._col_splits(2 * lc), S._col_splits(2 * lin)
    want = []
    for n in (2, 1):
        want += [("core_nn", S.EPI_SWIGLU, n * lc, k * c, 2 * ip),
                 ("core_nn", S.EPI_STORE, n * lin, k * ip, c)]
    for n in (2, 1):
        want += [("core_nn", S.EPI_SWIGLU, n * lc, k * c, 2 * ip),
                 ("core_nn", S.EPI_SWIGLU_BWD, n * lc, k * c, ip),
                 ("core_nn", S.EPI_STORE, n * lin, k * 2 * ip, c),
                 ("core_tn", 2 * ip, k * c, n * lc, s1), ("colsum", 2 * ip, n * lc, sb),
                 ("core_tn", ip, k * c, n * lc, s2), ("colsum", c, n * lin, sdb)]
    assert prims.log == want
    assert prims.calls["reduce"] == 4              # one per gradient, <= 256 partials each
    assert U._core_gemms(prims) is prims


def test_fp32_core_gate_and_layouts():
    """The gate admits every shape it admitted with the FFMA GEMMs (C of
    whole float4s, any inner width, 2 <= k <= 8), in training too; the
    layouts' bytes (pinned; the compiled kernels' own count on the card)."""
    assert U.core_launch_bytes() == {"nn": 197632, "nn64": 132096, "tn": 104448,
                                     "nn96": 164864}
    for c in range(1, 300):
        for inner in (1, 30, 192, 1024):
            for k in range(1, 10):
                want = c % 4 == 0 and 2 <= k <= 8
                assert U.supports_core(c, inner, k) == U.supports_core(c, inner, k, True) == want
