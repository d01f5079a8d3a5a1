"""A multi-process dry run of the train and eval steps
(``__graft_entry__.py::dryrun_multichip``):

    python -m podtpu_torch.parallel.dryrun --nproc 4 [--device cuda|cpu]

spawns ``--nproc`` ranks that meet over ``gloo`` through a file store
(sharing the cards, by default, or on the CPU with ``--device cpu``), and
on each runs YOLOv3 at 64 px float32 with ``device_augment``,
``device_geom``, ``ema`` and hflip + scale TTA on a global batch of one
image a rank: one data-parallel train step; then under FSDP, where at
least 10 parameter leaves must be sharded, one step (its loss equal to
the data-parallel one, its updated weights in agreement); then, as
``dryrun_multichip`` picks them, the layouts: ``--nproc`` >= 4 (even)
adds spatial 2 with FSDP, >= 8 (a multiple of 4) tensor 2 as well, one
step held to the data-parallel one likewise; then a K=2 group
(``steps_per_dispatch``) and the eval step on the whole weights. Exits
non-zero if a rank fails or hangs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from podtpu_torch.parallel import mesh

VOC_ANCHORS = [[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
               [59, 119], [116, 90], [156, 198], [373, 326]]


def flagship_cfg(input_size: int = 64) -> dict:
    """YOLOv3 on Darknet-19 (``configs/yolov3_voc.yaml``'s recipe) at
    ``input_size`` px, float32, with the device augmentation, the EMA and
    TTA on, as ``dryrun_multichip`` runs it."""
    return {
        "model": "yolov3", "num_classes": 20, "input_size": input_size,
        "in_channels": 3, "compute_dtype": "float32",
        "anchors": VOC_ANCHORS, "conf_threshold": 0.25,
        "nms_iou_threshold": 0.45, "top_k_candidates": 512,
        "max_detections": 100, "optimizer": "sgd",
        "optimizer_options": {"lr": 1e-3, "momentum": 0.9,
                              "weight_decay": 1e-2, "nesterov": True},
        "scheduler": "yolo_lr",
        "scheduler_options": {"burn_in": 1000, "steps": [40000],
                              "scales": [0.1]},
        "max_annots": 8, "seed": 0,
        "device_augment": True, "device_geom": True,
        "ema": {"decay": 0.99, "tau": 4.0},
        "tta": {"hflip": True, "scales": [0.5]},
    }


def global_batch(n: int, size: int, max_annots: int) -> dict:
    """One seeded image a rank, uint8, with one box and a warp row each."""
    imgs = np.random.default_rng(0).integers(0, 256, (n, size, size, 3),
                                             dtype=np.uint8)
    annot = -np.ones((n, max_annots, 5), np.float32)
    annot[:, 0] = [0.5, 0.5, 0.4, 0.4, 3]
    geom = np.tile(np.array([0.8, 0.8, 6.0, -4.0], np.float32), (n, 1))
    return {"img": imgs, "annot": annot, "geom": geom}


def layouts_for(nproc: int) -> tuple[int, int, bool]:
    """(spatial, tensor, fsdp) as ``__graft_entry__.py::dryrun_multichip``
    picks them for ``nproc`` devices."""
    spatial = 2 if (nproc >= 4 and nproc % 2 == 0) else 1
    tensor = 2 if (nproc >= 8 and nproc % 4 == 0) else 1
    return spatial, tensor, spatial > 1


def run_checks(dev: torch.device) -> dict:
    """The dry run on this rank of a joined group: returns its numbers,
    raising on a failed check."""
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import (
        make_eval_step,
        make_multi_train_step,
        make_train_step,
    )
    from podtpu_torch.train.trainer import whole_payload

    cfg = flagship_cfg()
    n = torch.distributed.get_world_size()
    host = global_batch(n, cfg["input_size"], cfg["max_annots"])
    spatial, tensor, fsdp = layouts_for(n)
    runs = [("dp", 1, 1, False), ("fsdp", 1, 1, True)]
    if spatial * tensor > 1:
        runs.append(("layout", spatial, tensor, fsdp))
    out = {"layout": (n // (spatial * tensor), spatial, tensor)}
    for layout, s, t, f in runs:
        grid = mesh.make_mesh(dev.type, s, t)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in mesh.shard_batch(host).items()}
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg["seed"])
            state = create_train_state(cfg, dev,
                                       fsdp_mesh=grid if f else None)
        if layout == "fsdp":
            out["fsdp_sharded_leaves"] = mesh.sharded_leaves(state.model)
            if out["fsdp_sharded_leaves"] < 10:
                raise AssertionError("the FSDP layout did not shard the "
                                     "parameters")
        state, metrics = make_train_step(cfg)(state, batch)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"{layout}: non-finite loss {loss}")
        # the global batch's loss: the mean of the data ranks'
        out[f"{layout}_loss"] = mesh.mean_over_ranks(loss)
        whole = whole_payload(state, {"model": mesh.full_tree(
            state.model.state_dict())})["model"]
        # copies: the K=2 group below moves the last run's statistics
        out[f"{layout}_weights"] = {k: v.detach().cpu().numpy().copy()
                                    for k, v in whole.items()}
    stacked = {k: torch.from_numpy(v).to(dev) for k, v in
               mesh.shard_stacked_batch({k: np.stack([a] * 2)
                                         for k, a in host.items()}).items()}
    state, metrics = make_multi_train_step(dict(cfg, steps_per_dispatch=2))(
        state, stacked)
    if metrics["loss"].shape != (2,) or not torch.isfinite(
            metrics["loss"]).all():
        raise AssertionError("the K=2 group failed")
    # the eval step on the whole weights (a plain model holding them, as
    # Trainer.validate evaluates under FSDP)
    model = build_model(cfg, dev, train=True)
    model.load_state_dict(whole_payload(state, {"model": mesh.full_tree(
        state.model.state_dict())})["model"])
    state.model = model
    val_loss, dets, valid = make_eval_step(cfg)(
        state, {"img": batch["img"], "annot": batch["annot"]})
    if not np.isfinite(float(val_loss)) or dets.shape[0] != len(
            batch["img"]):
        raise AssertionError("the eval step failed")
    out["val_loss"] = float(val_loss)
    for layout, *_ in runs[1:]:
        if abs(out[f"{layout}_loss"] - out["dp_loss"]) > 1e-5 * abs(
                out["dp_loss"]):
            raise AssertionError(f"{layout} loss {out[f'{layout}_loss']} "
                                 f"against DP {out['dp_loss']}")
        worst = max(float(np.abs(out[f"{layout}_weights"][k] - w).max()
                          / max(1.0, float(np.abs(w).max())))
                    for k, w in out["dp_weights"].items())
        if worst > 1e-5:
            raise AssertionError(f"{layout}'s updated weights differ from "
                                 f"DP's by {worst} of their scale")
        out[f"{layout}_vs_dp"] = worst
    return out


def _cards() -> int:
    """The cards a rank may take; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run the "
                           "ranks on the CPU")
    return torch.cuda.device_count()


def _rank_main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = (torch.device("cpu") if args.device == "cpu" else
           torch.device("cuda", args.rank % _cards()))
    # float32 as float32: with TF32 the DP and FSDP steps' convolutions
    # (other layouts, other algorithms) round apart by ~1e-3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.join("gloo", dev, args.rank, args.world, f"file://{args.store}")
    try:
        out = run_checks(dev)
    finally:
        mesh.shutdown()
    extra = (f" (data, space, model)={out['layout']} "
             f"loss={out['layout_loss']:.6f}" if "layout_loss" in out else "")
    print(f"dryrun rank {args.rank}/{args.world} on {dev}: "
          f"dp loss={out['dp_loss']:.6f} fsdp loss={out['fsdp_loss']:.6f} "
          f"sharded leaves={out['fsdp_sharded_leaves']}{extra} "
          f"val_loss={out['val_loss']:.6f} OK", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the ranks' device (default cuda, the ranks sharing "
                         "the cards; cpu for local runs)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        _cards()
    store = os.path.join(tempfile.mkdtemp(prefix="podtpu_dryrun_"), "store")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "podtpu_torch.parallel.dryrun", "--rank-of",
         "--rank", str(r), "--world", str(args.nproc), "--store", store,
         "--device", args.device], start_new_session=True)
        for r in range(args.nproc)]
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=args.timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    return 0 if codes == [0] * args.nproc else 1


if __name__ == "__main__":
    if "--rank-of" in sys.argv:
        sys.argv.remove("--rank-of")
        _rank_main(sys.argv[1:])
    else:
        sys.exit(main())
