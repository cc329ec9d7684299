"""The port's parallel pieces in one process on the CPU against the JAX
package: the fused steps' partial-sum mode (``residual=False``: the plain
versions against the JAX plain references and against ``_attn_forward`` /
``_blk_forward`` and their backward kernels in Pallas interpret mode, on
one device, no ``shard_map``), the shard seed fold, the TP sharding rules
against ``tp_shardings``' specs, ``validate_tp``, the multihost helpers and
the loader's ``shard=``, the CLIs' rank flags, the convert CLI, and the
package's imports and refusal strings.  Tiny shapes: emb 32, 2-4 heads, I
64, fp32.  Tolerance of the partial-sum comparisons: atol 2e-4 x max|ref|,
rtol 2e-3 (``tests/test_tp_fused.py``'s)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh as JMesh

from mss_tf_locoformer_tpu.core import config as JC
from mss_tf_locoformer_tpu.data.loader import DataLoader as JaxLoader
from mss_tf_locoformer_tpu.ops.pallas import attention_block as JAB
from mss_tf_locoformer_tpu.ops.pallas import swiglu_block as JFB
from mss_tf_locoformer_tpu.parallel import multihost as JMH
from mss_tf_locoformer_tpu.parallel import sharding as JSH
from mss_tf_locoformer_tpu.parallel import tp_fused as JTP
from mss_tf_locoformer_tpu_torch.cli import convert as convert_cli
from mss_tf_locoformer_tpu_torch.cli import evaluate as eval_cli
from mss_tf_locoformer_tpu_torch.cli import train as train_cli
from mss_tf_locoformer_tpu_torch.cli import train_speech as speech_cli
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
from mss_tf_locoformer_tpu_torch.core import config as C
from mss_tf_locoformer_tpu_torch.data.loader import DataLoader
from mss_tf_locoformer_tpu_torch.models import build_model
from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
from mss_tf_locoformer_tpu_torch.parallel import mesh as M
from mss_tf_locoformer_tpu_torch.parallel import multihost as MH
from mss_tf_locoformer_tpu_torch.parallel import sharding as SH
from mss_tf_locoformer_tpu_torch.parallel import tp_fused as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mss_tf_locoformer_tpu_torch")
ATOL, RTOL = 2e-4, 2e-3
# the tiny config the parallel tests share: emb 32, 2 heads of 16, I 64
TINY = dict(n_fft=256, hop_length=64, n_layers=2, emb_dim=32, num_groups=4, n_heads=2,
            attention_dim=32, ffn_type=("swiglu_conv1d", "swiglu_conv1d"),
            ffn_hidden_dim=(64, 64), conv1d_kernel=4, conv1d_shift=1, fused_ffn=True,
            flash_attention=True, fused_stft=True)


def _close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=ATOL * np.abs(want).max(),
                               rtol=RTOL, err_msg=name)


def _ffn_args(rng, r=2, seq=37, c=32, inner=64, k=4):
    f32 = lambda a: np.asarray(a, np.float32)
    b = (c * k) ** -0.5
    return [f32(rng.standard_normal((r, seq, c))), f32(1 + 0.1 * rng.standard_normal(c)),
            f32(rng.uniform(-b, b, (2 * inner, c, k))), f32(rng.uniform(-b, b, 2 * inner)),
            f32(rng.uniform(-b, b, (inner, c, k)))]


def _attn_args(rng, r=2, seq=37, c=32, a=32):
    f32 = lambda v: np.asarray(v, np.float32)
    return [f32(0.5 * rng.standard_normal((r, seq, c))), f32(1 + 0.1 * rng.standard_normal(c)),
            f32(rng.standard_normal((3 * a, c)) / np.sqrt(c)),
            f32(rng.standard_normal((c, a)) / np.sqrt(a))]


def _torch_vjp(fn, args, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    return out.detach().numpy(), [t.numpy() for t in torch.autograd.grad(out, ts,
                                                                         torch.from_numpy(g))]


def _jax_vjp(fn, args, g, interpret=False):
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
            return np.asarray(out), [np.asarray(v) for v in vjp(jnp.asarray(g))]
    out, grads = jax.jit(lambda g, *a: (fn(*a), jax.vjp(fn, *a)[1](g)))(
        jnp.asarray(g), *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(v) for v in grads]


@pytest.mark.parametrize("interpret", [False, True], ids=["reference", "pallas-interpret"])
def test_ffn_partial_sum_matches_jax(rng, interpret):
    """The FFN step's plain partial-sum mode (no bias: the TP caller's)
    against the JAX plain reference, or ``_blk_forward`` / ``_blk_backward``
    in interpret mode, with ``residual=False`` and a zero bias."""
    args = _ffn_args(rng)
    g = rng.standard_normal(args[0].shape).astype(np.float32)
    zero = np.zeros(args[0].shape[-1], np.float32)
    out, got = _torch_vjp(lambda *a: FB.fused_norm_ffn_residual(
        *a, None, 4, 4, 1e-5, residual=False), args, g)
    if interpret:
        jfn = lambda *a: JFB.fused_norm_ffn_residual(*a, jnp.asarray(zero), 4, 4, 1e-5,
                                                     residual=False)
    else:
        jfn = lambda *a: JFB.reference_norm_ffn_residual(*a, jnp.asarray(zero), 4, 4, 1e-5,
                                                         residual=False)
    want_out, want = _jax_vjp(jfn, args, g, interpret)
    _close(out, want_out, "out")
    for name, a, w in zip(("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w"), got, want):
        _close(a, w, name)


@pytest.mark.parametrize("interpret,h", [(False, 1), (False, 2), (True, 2)],
                         ids=["reference-h1", "reference-h2", "pallas-interpret-h2"])
def test_attention_partial_sum_matches_jax(rng, interpret, h):
    """The attention step's plain partial-sum mode against the JAX plain
    reference, or ``_attn_forward`` / ``_attn_backward_pallas`` in
    interpret mode, with ``residual=False``, at a shard's width (A 16)."""
    args = _attn_args(rng, a=16)
    g = rng.standard_normal(args[0].shape).astype(np.float32)
    out, got = _torch_vjp(lambda *p: AB.fused_attention_block(
        *p, h, 4, 1e-5, True, residual=False), args, g)
    ref = JAB.fused_attention_block if interpret else JAB.reference_attention_block
    want_out, want = _jax_vjp(lambda *p: ref(*p, h, 4, 1e-5, True, residual=False), args, g,
                              interpret)
    _close(out, want_out, "out")
    for name, a, w in zip(("dx", "dgamma", "dw_qkv", "dw_out"), got, want):
        _close(a, w, name)


def test_partial_sum_mode_drops_the_outer_sites(rng):
    """``residual=False`` at dropout 0.1: the inner (and probability) masks
    stay, the outer (and post-projection) ones go: the partial output is
    ``full - x`` with the outer mask undone where it kept."""
    args = [torch.from_numpy(a) for a in _ffn_args(rng)]
    bias = torch.zeros(32)
    part = FB.fused_norm_ffn_residual(*args, None, 4, 4, 1e-5, 0.1, 77, residual=False)
    full = FB.fused_norm_ffn_residual(*args, bias, 4, 4, 1e-5, 0.1, 77)
    keep = (full - args[0]) != 0
    assert 0.8 < keep.float().mean() < 1.0
    torch.testing.assert_close((full - args[0])[keep], part[keep] / 0.9, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="deconv bias"):
        FB.fused_norm_ffn_residual(*args, bias, 4, 4, 1e-5, residual=False)


# ------------------------------------------------------------------ seeds

@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2), (4, 2), (1, 4), (3, 1)])
def test_local_seed_matches_the_jax_fold(dp, mp):
    """``_local_seed`` equals the JAX fold (int32 arithmetic, axis indices
    as ``jax.lax.axis_index`` gives them) for every shard and some seeds,
    and ``dp_seed`` is the fold of the dp index alone."""
    for seed in (0, 1, 12345, 2**31 - 1):
        for d in range(dp):
            for m in range(mp):
                mesh = M.Mesh(dp, mp, d, m)
                want = int(jnp.int32(seed) + jnp.int32(d * mp + m)
                           * jnp.int32(JTP._SHARD_SEED_STRIDE))
                assert TP._local_seed(seed, mesh) == want
                assert TP.dp_seed(seed, mesh) == TP._local_seed(seed, M.Mesh(dp, 1, d, 0))
    assert TP._SHARD_SEED_STRIDE == JTP._SHARD_SEED_STRIDE
    assert TP._local_seed(None, M.Mesh(2, 2, 1, 1)) is None
    assert TP.dp_seed(5, None) == 5


def test_shard_seed_stride_avoids_in_kernel_collisions():
    """The JAX test (``tests/test_tp_fused.py``) on the port's stride: the
    fold must not reuse the golden-ratio word the JAX in-kernel generators
    mix tile indices with (shard idx+1 at tile t would replay shard idx's
    tile t+1); the per-(shard, tile) seed words stay pairwise distinct.
    The port's Philox masks take the row, head and position as counters, so
    the fold only has to keep the shards' keys apart, which this implies."""
    g = int(JAB._PROB_TILE_STRIDE) & 0xFFFFFFFF
    a = int(TP._SHARD_SEED_STRIDE) & 0xFFFFFFFF
    assert a != g and int(JFB._TILE_SEED_STRIDE) & 0xFFFFFFFF == g
    shards = np.arange(16, dtype=np.int64)
    tiles = np.arange(1, 8193, dtype=np.int64)
    seeds = (shards[:, None] * a + tiles[None, :] * g) % (1 << 32)
    assert np.unique(seeds).size == seeds.size
    bad = (shards[:, None] * g + tiles[None, :] * g) % (1 << 32)
    assert np.unique(bad).size < bad.size
    # the folded seeds of 16 shards, as the kernels get them: all distinct
    got = {TP._local_seed(1234, M.Mesh(4, 4, d, m)) for d in range(4) for m in range(4)}
    assert len(got) == 16


# ---------------------------------------------------------- sharding rules

def test_shard_axes_match_jax_tp_shardings():
    """Every key of a tiny model: the axis the port splits is the one the
    JAX ``tp_shardings`` spec shards (``mp``), or none where the spec
    replicates (the deconv bias included: exact segment matching)."""
    cfg = C.ModelConfig(**TINY)
    sd = build_model(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    # the JAX rules read path segments: the port's keys as a nested tree
    tree = {}
    for k, v in sd.items():
        node = tree
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(v.shape, np.float32)
    mesh = JMesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("dp", "mp"))
    specs = jax.tree_util.tree_flatten_with_path(JSH.tp_shardings(tree, mesh))[0]
    split = 0
    for path, sharding in specs:
        key = ".".join(p.key for p in path)
        spec = tuple(sharding.spec) + (None,) * (sd[key].dim() - len(sharding.spec))
        want = [i for i, s in enumerate(spec) if s == "mp"]
        assert SH.shard_axis(key) == (want[0] if want else None), key
        split += bool(want)
        shard = SH.shard_tensor(key, sd[key], 1, 2)
        if want:
            assert shard.shape[want[0]] * 2 == sd[key].shape[want[0]], key
        else:
            assert shard is sd[key], key
    assert split == 2 * 2 * (2 + 3 * 2)   # layers x paths x (qkv, out; 2 FFNs x 3)
    assert SH.shard_axis("blocks.0.freq_path.ffn.0.deconv1d.bias") is None


@pytest.mark.parametrize("mp", [2, 4])
def test_shards_are_whole_heads_and_channels_and_gather_back(mp):
    """A shard is the weight of a model with H/mp heads and I/mp inner
    channels (head-major ``[3, H, D, C]``, half-major ``[2, I, C, k]``),
    and ``gather_state_dict(shard_state_dict(sd)) == sd``."""
    cfg = C.ModelConfig(**dict(TINY, n_heads=4))
    sd = build_model(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    shards = [SH.shard_state_dict(sd, i, mp) for i in range(mp)]
    back = SH.gather_state_dict(shards)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    qkv = sd["blocks.0.freq_path.attn.qkv.weight"].reshape(3, 4, 8, 32)
    for i, s in enumerate(shards):
        h = 4 // mp
        torch.testing.assert_close(s["blocks.0.freq_path.attn.qkv.weight"],
                                   qkv[:, i * h:(i + 1) * h].reshape(-1, 32))
        cw = sd["blocks.0.freq_path.ffn.1.conv1d.weight"].reshape(2, 64, 32, 4)
        n = 64 // mp
        torch.testing.assert_close(s["blocks.0.freq_path.ffn.1.conv1d.weight"],
                                   cw[:, i * n:(i + 1) * n].reshape(-1, 32, 4))


def test_validate_tp_raises_as_the_jax_one():
    for kw, mp in ((dict(n_heads=2, attention_dim=32), 4),    # heads
                   (dict(n_heads=4, attention_dim=36), 2),    # attention_dim % (H mp)
                   (dict(n_heads=4, attention_dim=32, ffn_hidden_dim=(64, 66)), 4),
                   (dict(n_heads=4, attention_dim=32, ffn_hidden_dim=(64, 65)), 2)):
        raw = dict(TINY, **kw)
        with pytest.raises(ValueError) as want:
            JSH.validate_tp(JC.ModelConfig(**raw), mp)
        with pytest.raises(ValueError) as got:
            SH.validate_tp(C.ModelConfig(**raw), mp)
        assert str(got.value) == str(want.value)
    SH.validate_tp(C.ModelConfig(**TINY), 2)
    SH.validate_tp(C.ModelConfig(**TINY), 1)


def test_sharded_block_takes_per_shard_routes_or_raises():
    """``shard_module`` sets every block to its shard's widths; a shard the
    FFN step's wmma gate refuses at C 32 (I 64 / 4 = 16, not whole 32-
    channel chunks) raises when the block runs, never reroutes."""
    model = build_model(C.ModelConfig(**TINY), generator=torch.Generator().manual_seed(0))
    SH.shard_module(model, M.Mesh(1, 2))
    block = model.blocks[0].freq_path
    assert block.attn.n_heads == 1 and block.ffn[0].dim_inner == 32
    assert block.attn.qkv.weight.shape == (48, 32) and block.attn.qkv.weight.tp_axis == 0
    assert block.train().fused_steps() == ([True, True], True)
    model = build_model(C.ModelConfig(**dict(TINY, n_heads=4)),
                        generator=torch.Generator().manual_seed(0))
    SH.shard_module(model, M.Mesh(1, 4, 0, 3))
    with pytest.raises(ValueError, match="fused steps only"):
        model.blocks[0].freq_path.eval().fused_steps()


def test_mesh_without_a_process_group():
    mesh = M.make_mesh()
    assert (mesh.dp, mesh.mp, mesh.shard_index) == (1, 1, 0)
    assert M.active_mesh() is None
    with M.activate_mesh(M.Mesh(2, 2, 1, 0)):
        assert M.tp_mesh().mp == 2
        with M.activate_mesh(None):
            assert M.active_mesh() is None
    assert M.active_mesh() is None
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        M.make_mesh(2, 1)
    batch = {"mixture": torch.arange(8).reshape(4, 2)}
    assert M.shard_batch(M.Mesh(2, 2, 1, 1), batch)["mixture"].tolist() == [[4, 5], [6, 7]]


# ------------------------------------------------------- multihost helpers

@pytest.mark.parametrize("n,world", [(10, 3), (7, 7), (5, 8), (16, 4)])
def test_shard_indices_match_jax(n, world):
    for rank in range(world):
        assert MH.shard_indices(n, rank, world) == JMH.shard_indices(n, rank, world)


def test_local_batch_size_matches_jax(monkeypatch):
    for n in (1, 2, 4):
        monkeypatch.setattr(jax, "process_count", lambda n=n: n)
        for gb in (4, 8, 6):
            try:
                want = JMH.local_batch_size(gb)
            except ValueError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    MH.local_batch_size(gb, n)
                continue
            assert MH.local_batch_size(gb, n) == want
    assert MH.local_batch_size(8) == 8 and MH.process_count() == 1 and MH.is_coordinator()
    assert MH.broadcast_from_coordinator({"a": 1}) == {"a": 1}


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("world", [2, 3])
def test_loader_shard_matches_jax(shuffle, world):
    """The loader's ``shard=`` takes the JAX loader's batches: the same
    shard-independent shuffle, then an equal round-robin share."""
    class DS:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"mixture": np.full((2, 3), i, np.float32)}

    for rank in range(world):
        kw = dict(batch_size=2, shuffle=shuffle, seed=5, drop_last=True,
                  shard=(rank, world))
        got = [b["mixture"][:, 0, 0].tolist() for b in DataLoader(DS(), **kw)]
        want = [np.asarray(b["mixture"])[:, 0, 0].tolist() for b in JaxLoader(DS(), **kw)]
        assert got == want and len(DataLoader(DS(), **kw)) == len(want)
    with pytest.raises(ValueError, match="bad shard"):
        DataLoader(DS(), shard=(2, 2))


def test_rank_device_backends():
    """CPU ranks and ranks that share one card take gloo; ranks with a card
    each take NCCL (decided from the device string alone)."""
    assert MH.rank_device("cpu", 1, 2) == (torch.device("cpu"), "gloo")
    if torch.cuda.device_count() == 0:   # the card's answers need a card
        return
    assert MH.rank_device("cuda:0", 1, 2)[1] == "gloo"
    assert MH.rank_device("cuda", 0, 1) == (torch.device("cuda", 0), "nccl")


@pytest.mark.parametrize("cli", [train_cli, speech_cli, eval_cli], ids=["train", "speech", "eval"])
def test_rank_flags_without_distributed_raise(cli):
    """As the JAX CLI: rank flags alone would run N independent jobs."""
    args = ["--config", "x.yaml"] + (["--checkpoint", "m.pth"] if cli is eval_cli else [])
    for extra in (["--num_processes", "2"], ["--process_id", "1"]):
        with pytest.raises(SystemExit):
            train_cli.maybe_init_distributed(cli.parse_args(args + extra))
    a = cli.parse_args(args)
    assert train_cli.maybe_init_distributed(a) == "cuda"   # no group: the device as given


def test_distributed_needs_torchrun_or_a_coordinator(monkeypatch):
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun environment"):
        MH.initialize(device="cpu")
    with pytest.raises(ValueError, match="--num_processes and --process_id"):
        MH.initialize("localhost:1", device="cpu")


# ----------------------------------------------------------------- convert

def test_convert_cli_both_reference_layouts(tmp_path):
    """Trainer-wrapped and ESPnet ``separator.`` layouts -> the port's
    ``.pth``, which loads ``strict=True``; an orbax directory raises naming
    the JAX CLI."""
    cfg = C.ModelConfig(**TINY)
    sd = build_model(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    cfg_path = tmp_path / "model.json"
    import json
    cfg_path.write_text(json.dumps({"model": dict(TINY, ffn_type=list(TINY["ffn_type"]),
                                                  ffn_hidden_dim=list(TINY["ffn_hidden_dim"]))}))
    layouts = {"trainer": {"model_state_dict": sd, "epoch": 3},
               "espnet": {**{f"separator.{k}": v for k, v in sd.items()},
                          "encoder.x": torch.zeros(1)}}
    for name, blob in layouts.items():
        src, dst = tmp_path / f"{name}.pth", tmp_path / f"{name}_port.pth"
        torch.save(blob, src)
        convert_cli.main(["--input", str(src), "--output", str(dst), "--config", str(cfg_path)])
        out = torch.load(dst, weights_only=True)
        assert out.keys() == sd.keys()
        model = build_model(cfg)
        model.load_state_dict(out, strict=True)
        for k in sd:
            assert torch.equal(out[k], sd[k])
    orbax = tmp_path / "ckpt"
    orbax.mkdir()
    with pytest.raises(ValueError, match="mss_tf_locoformer_tpu.cli.convert"):
        convert_cli.main(["--input", str(orbax), "--output", str(tmp_path / "x.pth")])


# --------------------------------------------------------- package checks

def test_parallel_modules_import_no_jax():
    """The new modules exist and import neither ``jax`` nor the JAX package
    (the package-wide check is tests/test_torch_model.py's)."""
    names = ["parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py",
             "parallel/tp_fused.py", "parallel/multihost.py", "cli/convert.py"]
    for name in names:
        src = open(os.path.join(PKG, name)).read()
        assert not re.search(r"^\s*(import|from)\s+(jax|mss_tf_locoformer_tpu)\b", src, re.M), name


def test_no_parallel_runs_refusal_left():
    """No module of the port refuses a parallel run any more."""
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert "Queue 1: parallel runs" not in src, os.path.join(root, f)
                assert "refuse_distributed" not in src, os.path.join(root, f)


def test_jax_params_tree_shards_like_the_state_dict(rng):
    """The JAX model's parameters, carried across by key rename, shard the
    same way (the split applies to JAX-exported weights too)."""
    from mss_tf_locoformer_tpu.models.mss_tflocoformer import TFLocoformerMSS as JaxMSS
    jcfg = JC.ModelConfig(**TINY)
    shapes = jax.eval_shape(lambda: JaxMSS(jcfg).init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, 1024), jnp.float32)))
    params = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                                    shapes)
    sd = jax_params_to_state_dict(params)
    model = build_model(C.ModelConfig(**TINY))
    model.load_state_dict(sd, strict=True)
    SH.shard_module(model, M.Mesh(1, 2, 0, 1))
    model.load_state_dict(SH.shard_state_dict(sd, 1, 2), strict=True)
