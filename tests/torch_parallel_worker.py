"""One rank of the port's multi-process CPU tests (``tests/
test_torch_parallel_runs.py``), over gloo on localhost:

    python tests/torch_parallel_worker.py MODE RANK WORLD PORT DIR

MODE ``tp`` (mesh 1 x WORLD): the TP attention and FFN steps on ``DIR/
in.npz`` (forward and gradients, weight gradients gathered whole), and
with WORLD 2 one AdamW step of ``DIR/model.pth`` on ``DIR/batch.npz``;
``dp`` (mesh 2 x 1): the same AdamW step on this rank's rows, the trainer
fit and resume, the evaluation CLI and the chunk-parallel engine;
``seeds`` (mesh 2 x 2): a block's forward at dropout 0.1 on the same
input everywhere.  Rank 0 writes ``DIR/<mode>_out.pt``.  No JAX: the
parent test holds the results against the JAX package.
"""

import functools
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mss_tf_locoformer_tpu_torch.core import config as C  # noqa: E402
from mss_tf_locoformer_tpu_torch.models import build_model  # noqa: E402
from mss_tf_locoformer_tpu_torch.parallel import mesh as M  # noqa: E402
from mss_tf_locoformer_tpu_torch.parallel import multihost as MH  # noqa: E402
from mss_tf_locoformer_tpu_torch.parallel import sharding as SH  # noqa: E402
from mss_tf_locoformer_tpu_torch.parallel import tp_fused as TP  # noqa: E402
from mss_tf_locoformer_tpu_torch.train.state import make_optimizer  # noqa: E402
from mss_tf_locoformer_tpu_torch.train.step import train_step  # noqa: E402

ATTN_KEYS = ("attn.qkv.weight", "attn.aggregate_heads.0.weight")
FFN_KEYS = ("ffn.0.conv1d.weight", "ffn.0.conv1d.bias", "ffn.0.deconv1d.weight")


def _gather(t, mesh):
    parts = [torch.empty_like(t) for _ in range(mesh.mp)]
    dist.all_gather(parts, t.contiguous(), group=mesh.mp_group)
    return parts


def _tp_steps(mesh, d):
    """Forward and gradients of both TP steps; weight gradients whole."""
    out = {}
    t = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(d, "in.npz")).items()}
    for name, keys, step in (
            ("attn", ATTN_KEYS, lambda x, gm, wq, wo: TP.tp_attention_step(
                x, gm, wq, wo, int(t["heads"]) // mesh.mp, 4, 1e-5, True, 10000.0, 0.0, 0,
                mesh)),
            ("ffn", FFN_KEYS, lambda x, gm, cw, cb, dw: TP.tp_ffn_step(
                x, gm, cw, cb, dw, 4, 4, 1e-5, 0.0, 0, mesh))):
        x = t[f"{name}_x"].clone().requires_grad_(True)
        gamma = t[f"{name}_gamma"].clone().requires_grad_(True)
        ws = [SH.shard_tensor(k, t[f"{name}_{k}"], mesh.mp_index, mesh.mp).requires_grad_(True)
              for k in keys]
        y = step(x, gamma, *ws)
        grads = torch.autograd.grad(y, [x, gamma, *ws], t[f"{name}_g"])
        out[f"{name}_out"] = y.detach()
        out[f"{name}_dx"], out[f"{name}_dgamma"] = grads[0], grads[1]
        for k, gw in zip(keys, grads[2:]):
            out[f"{name}_d{k}"] = SH.unshard_tensor(k, _gather(gw, mesh))
    return out


def _adamw_step(mesh, d, rows):
    """One AdamW step of ``model.pth`` on ``rows`` of ``batch.npz`` under
    ``mesh``; returns the loss dict and the whole parameters after it."""
    raw = json.load(open(os.path.join(d, "cfg.json")))
    cfg = C.config_from_dict(raw)
    model = build_model(cfg.model)
    model.load_state_dict(torch.load(os.path.join(d, "model.pth"), weights_only=True))
    SH.shard_module(model, mesh)
    opt = make_optimizer(model.parameters(), cfg.training)
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(d, "batch.npz")).items()}
    batch = M.shard_batch(mesh, batch) if rows else batch
    mix = batch.pop("mixture")
    with M.activate_mesh(mesh):
        ld = train_step(model, opt, mix, batch, 1e-3, torch.Generator().manual_seed(0),
                        cfg.loss, cfg.training.gradient_accumulation_steps,
                        cfg.training.gradient_clip)
    return ({k: float(v) for k, v in ld.items()},
            SH.gather_over_mp(model.state_dict(), mesh, "cpu"))


def _fp32_loader():
    """The evaluation CLI's model loader at fp32 (the JAX CLI's side is
    held at fp32 too), so that the scores compare at 1e-3 dB."""
    from mss_tf_locoformer_tpu_torch.core.precision import FP32
    from mss_tf_locoformer_tpu_torch.infer import separate as S
    S.load_model = functools.partial(S.load_model, precision=FP32)


def main():
    mode, rank, world, port, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    addr = f"127.0.0.1:{port}"
    MH.initialize(addr, world, rank, device="cpu", timeout=45.0)
    torch.manual_seed(0)
    out = {}
    if mode == "tp":
        mesh = M.make_mesh(1, world)
        out.update(_tp_steps(mesh, d))
        if world == 2:
            out["step"] = _adamw_step(mesh, d, rows=False)
    elif mode == "dp":
        mesh = M.make_mesh(2, 1)
        out["step"] = _adamw_step(mesh, d, rows=True)
        from mss_tf_locoformer_tpu_torch.cli import evaluate as eval_cli
        from mss_tf_locoformer_tpu_torch.cli import train as train_cli
        flags = ["--coordinator_address", addr, "--num_processes", str(world),
                 "--process_id", str(rank), "--device", "cpu"]
        args = ["--config", os.path.join(d, "train.json"), "--output_dir",
                os.path.join(d, "exp")] + flags
        first = train_cli.main(args)
        resumed = train_cli.main(args + ["--resume", "latest", "--config",
                                          os.path.join(d, "train_more.json")])
        out["fit"] = dict(steps=(first.step, resumed.step), start=resumed.start_epoch,
                          epochs=resumed.ckpt.epochs(), dp=first.mesh.dp,
                          verbose=(first.verbose, resumed.verbose))
        _fp32_loader()
        eval_cli.main(["--config", os.path.join(d, "train.json"), "--checkpoint",
                       os.path.join(d, "model.pth"), "--output_dir", os.path.join(d, "eval"),
                       "--chunk_seconds", "0.5", "--overlap_seconds", "0.125"] + flags)
        # chunk-parallel separation against the same engine on one rank
        from mss_tf_locoformer_tpu_torch.infer.separate import make_engine
        cfg = C.config_from_dict(json.load(open(os.path.join(d, "cfg.json"))))
        model = build_model(cfg.model)
        model.load_state_dict(torch.load(os.path.join(d, "model.pth"), weights_only=True))
        model.eval()
        audio = np.load(os.path.join(d, "batch.npz"))["mixture"].reshape(-1)[:7000]
        whole = make_engine(model, 0.25, 0.05, 8000, 2, "cpu")(audio)
        got = make_engine(model, 0.25, 0.05, 8000, 2, "cpu", mesh)(audio)
        out["engine"] = max(float(np.abs(got[k] - whole[k]).max()) for k in whole)
    elif mode == "seeds":
        mesh = M.make_mesh(2, 2)
        cfg = C.config_from_dict(json.load(open(os.path.join(d, "cfg.json"))))
        model = build_model(cfg.model, generator=torch.Generator().manual_seed(1))
        SH.shard_module(model, mesh)
        block = model.blocks[0].freq_path.train()
        x = torch.from_numpy(np.load(os.path.join(d, "batch.npz"))["x"])
        with torch.no_grad(), M.activate_mesh(mesh):
            block.dropout = 0.1
            y = block(x, seeds=[11, 22, 33])
            block.dropout = 0.0
            y0 = block(x, seeds=[11, 22, 33])
            # the outer sites' keep masks: where the step's output differs
            # from its input (an exact 0 kept is improbable)
            ffn_keep = (block.ffn[0].fused_step(x, block.ffn_norm[0].gamma, 4, 1e-5, 0.1, 11)
                        != x).to(torch.float32)
            rows = x.reshape(-1, *x.shape[2:])
            attn_keep = (block.attn.fused_step(rows, block.attn_norm.gamma, 4, 1e-5, 0.1, 22)
                         != rows).to(torch.float32)
        for name, t in (("outputs", y), ("ffn_keep", ffn_keep), ("attn_keep", attn_keep)):
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t.contiguous())
            out[name] = parts
        out["undropped"] = y0
        out["seeds"] = [TP._local_seed(11, M.Mesh(2, 2, r // 2, r % 2)) for r in range(world)]
    if rank == 0:
        torch.save(out, os.path.join(d, f"{mode}_out.pt"))
    MH.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
