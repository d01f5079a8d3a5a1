"""One rank of the ``gloo`` jobs that ``tests/test_torch_parallel.py`` and
``tests/test_torch_layouts.py`` hold against one-process runs and
``podtpu``.

    python -m tests.torch_parallel_job RANK WORLD STORE OUT [four]

Each rank joins the group through a file store, runs every check on its
rows of the global inputs and weights (made from numpy seeds by
:func:`inputs` and :func:`seeded_flat`, which the test's process calls
too) and writes its results to ``OUT`` as an ``.npz``. The two-rank job
runs data parallelism and FSDP, then the tensor layout on a ``(model=2)``
mesh and the spatial layout on a ``(space=2)`` mesh (:func:`layouts_run`);
``four`` runs the four-rank compositions (:func:`four_run`). It imports
no JAX: the references are computed by the tests.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tests.helpers import VOC_ANCHORS

C = 20
B = 4  # the global batch of every check: two rows a rank
B96 = 2  # the layouts' global batch at 96 px (every rank holds both rows)


def yolo_cfg(**extra) -> dict:
    """``tests/torch_parity.py::yolo_cfg`` at 64 px float32 with
    ``tests/test_torch_train.py``'s optimizer (constant lr 1e-3)."""
    cfg = dict(model="yolov3", num_classes=C, anchors=VOC_ANCHORS,
               input_size=64, compute_dtype="float32", conf_threshold=0.25,
               nms_iou_threshold=0.45, top_k_candidates=512,
               max_detections=100, optimizer="sgd",
               optimizer_options={"lr": 1e-3, "momentum": 0.9,
                                  "weight_decay": 1e-2, "nesterov": True},
               scheduler=None, max_annots=8, seed=0)
    cfg.update(extra)
    return cfg


def options_cfg(**extra) -> dict:
    """``accum_steps: 2``, a clip the gradients exceed, the EMA and the
    non-finite guard."""
    cfg = yolo_cfg(ema={"decay": 0.9, "tau": 1.0}, **extra)
    cfg["optimizer_options"] = dict(cfg["optimizer_options"], accum_steps=2,
                                    clip_grad_norm=5.0, skip_nonfinite=1)
    return cfg


def yolov1_cfg() -> dict:
    cfg = yolo_cfg(model="yolov1", num_boxes=2)
    del cfg["anchors"]
    return cfg


def _boxes(r, n):
    rows = [[*r.uniform(0.2, 0.8, 2), *r.uniform(0.1, 0.6, 2),
             r.integers(0, C)] for _ in range(n)]
    return np.asarray(rows, np.float32)


def inputs() -> dict:
    """The global inputs of every check, from numpy seeds."""
    from podtpu_torch.data.loader import pad_annotations

    r = np.random.default_rng(21)
    out = {
        "bn_x": r.normal(0.5, 2.0, (B, 8, 6, 6)).astype(np.float32),
        "bn_w": r.uniform(0.5, 1.5, 8).astype(np.float32),
        "bn_b": r.normal(0.0, 0.1, 8).astype(np.float32),
        "bn_cot": r.normal(0.0, 1.0, (B, 8, 6, 6)).astype(np.float32),
        "stem_x": r.uniform(0.0, 1.0, (B, 16, 16, 3)).astype(np.float32),
        "stem_w": (r.normal(0.0, np.sqrt(2 / 27), (32, 3, 3, 3))
                   .astype(np.float32)),
        "stem_scale": r.uniform(0.5, 1.5, 32).astype(np.float32),
        "stem_bias": r.normal(0.0, 0.1, 32).astype(np.float32),
        "stem_cot": r.normal(0.0, 1.0, (B, 32, 8, 8)).astype(np.float32),
        "drop_x": np.ones((B, 5, 3), np.float32),
    }
    for i in range(3):  # three global train batches
        out[f"img{i}"] = r.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
        out[f"annot{i}"] = pad_annotations([_boxes(r, 5) for _ in range(B)],
                                           8)
    # RetinaNet's heads at 64 px, NHWC as podtpu lays them out, and targets
    for i, s in enumerate((8, 16, 32, 64, 128)):
        hw = -(-64 // s)
        out[f"retina_cls{i}"] = (r.normal(0.0, 2.0, (B, hw, hw, 9 * C))
                                 .astype(np.float32))
        out[f"retina_box{i}"] = (r.normal(0.0, 0.5, (B, hw, hw, 36))
                                 .astype(np.float32))
    out["retina_annot"] = pad_annotations(
        [_boxes(r, 1 + 2 * i) for i in range(B)], 8)
    # the layouts' batch at 96 px (an odd stride-32 grid of 3 rows)
    out["img96"] = r.integers(0, 256, (B96, 96, 96, 3), dtype=np.uint8)
    out["annot96"] = pad_annotations([_boxes(r, 4) for _ in range(B96)], 8)
    return out


def nan_batch(x: dict) -> dict:
    """Global batch 2 as float images with a NaN in the last row (the
    second rank's)."""
    img = x["img2"].astype(np.float32) / 255.0
    img[-1, 5, 7, 1] = np.nan
    return {"img": img, "annot": x["annot2"]}


def batch(x: dict, i: int) -> dict:
    return {"img": x[f"img{i}"], "annot": x[f"annot{i}"]}


def tensors(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def bn_run(x: dict, rows=slice(None)) -> dict:
    """A ``BatchNormMixed`` train-mode forward and backward."""
    from podtpu_torch.models.layers import BatchNormMixed

    bn = BatchNormMixed(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(x["bn_w"]))
        bn.bias.copy_(torch.from_numpy(x["bn_b"]))
    xi = torch.from_numpy(x["bn_x"][rows]).requires_grad_()
    out = bn(xi)
    (out * torch.from_numpy(x["bn_cot"][rows])).sum().backward()
    return {"out": out.detach(), "gx": xi.grad, "gw": bn.weight.grad,
            "gb": bn.bias.grad, "mean": bn.running_mean,
            "var": bn.running_var}


def stem_run(x: dict, rows=slice(None)) -> dict:
    """The fused stem op (``models/stem.py::fused_stem_pool``) forward and
    backward; on the CPU its plain version."""
    from podtpu_torch.models.layers import ConvBnAct
    from podtpu_torch.models.stem import fused_stem_pool

    block = ConvBnAct(3, 32)
    with torch.no_grad():
        block.conv.weight.copy_(torch.from_numpy(x["stem_w"]))
        block.bn.weight.copy_(torch.from_numpy(x["stem_scale"]))
        block.bn.bias.copy_(torch.from_numpy(x["stem_bias"]))
    xi = torch.from_numpy(x["stem_x"][rows]).permute(0, 3, 1, 2)
    out = fused_stem_pool(block, xi)
    (out.float() * torch.from_numpy(x["stem_cot"][rows])).sum().backward()
    return {"out": out.detach(), "gw": block.conv.weight.grad,
            "gscale": block.bn.weight.grad, "gbias": block.bn.bias.grad,
            "mean": block.bn.running_mean, "var": block.bn.running_var}


def seeded_flat(cfg: dict, seed: int) -> dict:
    """Seeded weights for ``cfg``'s model in ``podtpu``'s flat layout, as
    ``tests/torch_parity.py::module_flat_weights`` draws them (He-normal
    kernels, non-trivial BN affine and running statistics), made from the
    port's key set (a model on the meta device) and carried by
    ``export/weights.py``; the test's process and every rank make the same
    ones."""
    from podtpu_torch.export.weights import conv_paths, flat_from_tensors
    from podtpu_torch.models.factory import build_model

    model = build_model(cfg, torch.device("meta"), train=True)
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in sorted(model.state_dict().items()):
        shape = tuple(t.shape)
        if t.dim() >= 2:
            arr = rng.normal(0.0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        elif name.endswith("bn.weight"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("running_var"):
            arr = rng.uniform(0.5, 2.0, shape)
        else:  # BN bias, running mean, a linear's bias
            arr = rng.normal(0.0, 0.1, shape)
        sd[name] = torch.from_numpy(arr.astype(np.float32))
    return flat_from_tensors(sd, conv_paths(model))


def state_for(cfg: dict, flat: dict | None = None, fsdp=False):
    """A train state on the CPU in the process's layout; ``fsdp``: True
    (FSDP over a data axis made for it) or the mesh to shard over."""
    from podtpu_torch.parallel.mesh import make_mesh
    from podtpu_torch.train.state import create_train_state

    grid = None
    if fsdp:
        grid = make_mesh("cpu") if fsdp is True else fsdp
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        return create_train_state(cfg, "cpu", weights=flat, fsdp_mesh=grid)


def flat_of(state) -> dict:
    """The state's weights whole (FSDP's shards and the tensor layout's
    blocks gathered: every rank calls it)."""
    from podtpu_torch.export.weights import flat_from_state_dict

    return flat_from_state_dict(state.model)


def steps_run(cfg: dict, flat, batches, shard, fsdp=False,
              keep=(-1,)) -> dict:
    """Train steps over ``batches`` (global host batches), each fed through
    ``shard``; returns the losses, the flat weights after the steps in
    ``keep``, the clip's norms and, with the EMA, the whole shadow at the
    start and at the end."""
    import podtpu_torch.train.state as st
    from podtpu_torch.parallel.mesh import full_tree, sharded_leaves
    from podtpu_torch.train.steps import make_train_step

    state = state_for(cfg, flat, fsdp)
    if state.ema is not None:
        ema0 = {k: v.numpy().copy() for k, v in full_tree(state.ema).items()}
    step = make_train_step(cfg)
    clip, norms = st.clip_by_global_norm_, []

    def recorded(grads, max_norm, **kw):
        norm = clip(grads, max_norm, **kw)
        norms.append(float(norm))
        return norm

    st.clip_by_global_norm_ = recorded
    keep = [k % len(batches) for k in keep]
    out = {"loss": [], "flat": {}, "sharded": sharded_leaves(state.model)}
    try:
        for i, b in enumerate(batches):
            state, m = step(state, tensors(shard(b)))
            out["loss"].append(float(m["loss"]))
            if i in keep:
                out["flat"][i] = flat_of(state)
    finally:
        st.clip_by_global_norm_ = clip
    out.update(norms=norms, step=state.step, count=state.count,
               notfinite=state.total_notfinite)
    if state.ema is not None:
        out["ema"] = {k: v.numpy() for k, v in full_tree(state.ema).items()}
        out["ema0"] = ema0
    return out


def _exact(key: str) -> bool:
    """BN running statistics: kept whole in float32."""
    return key.startswith("batch_stats") or "running" in key


def compact(after: dict, before: dict) -> dict:
    """``after`` as its move from ``before``: each parameter's update
    scaled by its largest element and rounded to float16 (5e-4 of that
    scale, for checks at a few % of the update's norm), the BN running
    statistics whole."""
    out = {}
    for k, a in after.items():
        if _exact(k):
            out[f"exact/{k}"] = np.asarray(a, np.float32)
            continue
        d = np.asarray(a, np.float32) - before[k]
        scale = float(np.abs(d).max()) or 1.0
        out[f"q/{k}"] = (d / scale).astype(np.float16)
        out[f"scale/{k}"] = np.float32(scale)
    return out


def expand(res: dict, prefix: str, before: dict) -> dict:
    """The weights :func:`compact` kept under ``prefix`` in a job's
    results, rebuilt on ``before``."""
    out = {}
    for key, v in res.items():
        if key.startswith(prefix + "/exact/"):
            out[key[len(prefix) + 7:]] = v
        elif key.startswith(prefix + "/q/"):
            k = key[len(prefix) + 3:]
            out[k] = before[k] + v.astype(np.float32) * res[
                f"{prefix}/scale/{k}"]
    return out


def digest(flat: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    return h.hexdigest()


def closeness(got: dict, want: dict, rtol: float = 2e-4,
              atol: float = 1e-6) -> float:
    """max |got - want| / (atol + rtol |want|) over every leaf: at most 1
    where ``np.testing.assert_allclose(got, want, rtol, atol)`` holds."""
    assert set(got) == set(want)
    return max(float((np.abs(got[k] - want[k])
                      / (atol + rtol * np.abs(want[k]))).max())
               for k in want)


def stats_run(cfg: dict, flat, b: dict) -> dict:
    from podtpu_torch.train.steps import make_stats_step

    return make_stats_step(cfg)(state_for(cfg, flat), tensors(b))


def dropout_run(x: dict, rows=slice(None)) -> torch.Tensor:
    from podtpu_torch.models.layers import SeededDropout

    drop = SeededDropout(0.5).train()
    drop.reseed(7)
    return drop(torch.from_numpy(x["drop_x"][rows]))


def retina_run(x: dict, rows=slice(None)) -> dict:
    """``retinanet_loss`` on the rows' heads (NCHW, as the port's model
    gives them) and its gradient with respect to them."""
    from podtpu_torch.ops.retina import retinanet_loss

    heads = []
    for i in range(5):
        heads.append(tuple(
            torch.from_numpy(x[f"retina_{k}{i}"][rows]).permute(0, 3, 1, 2)
            .requires_grad_() for k in ("cls", "box")))
    loss = retinanet_loss(heads, torch.from_numpy(x["retina_annot"][rows]),
                          C, 64)
    loss.backward()
    grads = {f"g{k}{i}": h.grad.permute(0, 2, 3, 1)
             for i, pair in enumerate(heads)
             for k, h in zip(("cls", "box"), pair)}
    return {"loss": loss.detach(), **grads}


def flatten(prefix: str, tree, out: dict):
    """``{prefix/key...: array}`` of nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flatten(f"{prefix}/{k}", v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flatten(f"{prefix}/{i}", v, out)
    else:
        out[prefix] = np.asarray(tree.detach().numpy() if torch.is_tensor(tree)
                                 else tree)
    return out


def cfg96(**extra) -> dict:
    """:func:`yolo_cfg` at 96 px: YOLOv3's stride-32 grid is 3 rows, which
    2 space ranks cannot split (as 416 px's 13)."""
    return yolo_cfg(input_size=96, **extra)


def batch96(x: dict) -> dict:
    return {"img": x["img96"], "annot": x["annot96"]}


def eval_run(cfg: dict, flat, b: dict) -> dict:
    """The eval step (loss, detections) and the eval-mode heads of a fresh
    state holding ``flat``, in the process's layout."""
    from podtpu_torch.parallel.layouts import layout_scope, space_rows
    from podtpu_torch.train.steps import _as_input, make_eval_step

    state = state_for(cfg, flat)
    t = tensors(b)
    loss, dets, valid = make_eval_step(cfg)(state, t)
    model = state.model.eval()
    with torch.no_grad(), layout_scope(model):
        heads = model(space_rows(_as_input(t["img"]), model))
    return {"loss": loss, "dets": dets, "valid": valid,
            **{f"head{i}": h for i, h in enumerate(heads)}}


def stem_space_run(x: dict, zero_halo: bool = False) -> dict:
    """The fused stem op on this space rank's block of rows of every image
    (the plain twins with the halo), its pooled rows' cotangent block;
    ``zero_halo`` plants a halo of zeros in place of the neighbour's
    rows."""
    from podtpu_torch.models.layers import ConvBnAct
    from podtpu_torch.models.stem import fused_stem_pool
    from podtpu_torch.parallel import layouts, mesh
    from podtpu_torch.parallel.layouts import layout_scope, space_rows

    block = ConvBnAct(3, 32)
    block.layout = {"spatial": mesh.spatial_size()}
    with torch.no_grad():
        block.conv.weight.copy_(torch.from_numpy(x["stem_w"]))
        block.bn.weight.copy_(torch.from_numpy(x["stem_scale"]))
        block.bn.bias.copy_(torch.from_numpy(x["stem_bias"]))
    xi = space_rows(torch.from_numpy(x["stem_x"]), block).permute(0, 3, 1, 2)
    cot = torch.from_numpy(x["stem_cot"])
    k = cot.shape[2] // mesh.spatial_size()
    cot = cot[:, :, mesh.coords()[1] * k:(mesh.coords()[1] + 1) * k]
    halo = layouts.halo
    if zero_halo:
        layouts.halo = lambda t, a, b, fill=0.0: torch.nn.functional.pad(
            t, (0, 0, a, b))
    try:
        with layout_scope(block):
            out = fused_stem_pool(block, xi)
    finally:
        layouts.halo = halo
    (out.float() * cot).sum().backward()
    return {"out": out.detach(), "gw": block.conv.weight.grad,
            "gscale": block.bn.weight.grad, "gbias": block.bn.bias.grad,
            "mean": block.bn.running_mean, "var": block.bn.running_var}


def trainer_run(cfg: dict, b: dict) -> dict:
    """``Trainer`` from ``cfg`` (its ``parallel_options``): the layout it
    made, one train step and one eval step."""
    from podtpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device="cpu", eval_only=True, log=lambda m: None)
    t = tensors(b)
    state, m = trainer.train_step(trainer.state, t)
    loss, dets, _ = trainer.eval_step(state, t)
    layout = getattr(state.model, "layout", {})
    return {"spatial": layout.get("spatial", 1),
            "tensor": layout.get("tensor", 1),
            "split": len(getattr(state.model, "tp_keys", ())),
            "train_loss": m["loss"], "eval_loss": loss,
            "dets": dets.shape[1]}


def layouts_run(x: dict, flat: dict, rank: int) -> dict:
    """On a ``(model=2)`` mesh, then a ``(space=2)`` mesh, over the same two
    ranks: one train step and the eval step of YOLOv3 at 96 px, the
    planted fault of each layout, ``Trainer`` from ``parallel_options``;
    under ``space`` the stem op alone too."""
    from podtpu_torch.parallel import mesh

    out: dict = {}
    whole = lambda b: b  # noqa: E731  (a data axis of one rank)
    for key, axis in (("tensor", "model"), ("spatial", "space")):
        mesh.make_mesh("cpu", **{key: 2})
        run = steps_run(cfg96(), flat, [batch96(x)], whole)
        out[axis] = {"loss": run["loss"][0],
                     "digest": digest(run["flat"][0]),
                     "eval": eval_run(cfg96(), flat, batch96(x)),
                     "trainer": trainer_run(
                         cfg96(parallel_options={key: 2}), batch96(x))}
        if rank == 0:
            out[axis]["flat"] = compact(run["flat"][0], flat)
        if axis == "model":
            # planted: the whole leaves' gradients not reduced over model
            summed = mesh.sum_over_model
            mesh.sum_over_model = lambda *params: None
            try:
                bad = steps_run(cfg96(), flat, [batch96(x)], whole)
            finally:
                mesh.sum_over_model = summed
            if rank == 0:
                out[axis]["unsummed"] = compact(bad["flat"][0], flat)
        else:
            out[axis]["stem"] = stem_space_run(x)
            out[axis]["stem_zero_halo"] = stem_space_run(x, zero_halo=True)
    mesh.make_mesh("cpu")
    return out


def four_run(x: dict, flat: dict, rank: int) -> dict:
    """The four-rank compositions with FSDP at 64 px, one step each:
    ``(data=2, space=2)`` and ``(data=2, model=2)``."""
    from podtpu_torch.parallel import mesh

    out: dict = {}
    for key in ("spatial", "tensor"):
        grid = mesh.make_mesh("cpu", **{key: 2})
        run = steps_run(yolo_cfg(), flat, [batch(x, 0)], mesh.shard_batch,
                        fsdp=grid)
        out[key] = {"loss": mesh.mean_over_ranks(run["loss"][0]),
                    "digest": digest(run["flat"][0]),
                    "sharded": run["sharded"],
                    "shape": mesh.axis_sizes(),
                    "fsdp_ranks": mesh.fsdp_mesh(grid).size()}
        if rank == 0:
            out[key]["flat"] = compact(run["flat"][0], flat)
    return out


def main(argv):
    rank, world, store, out_path = argv[:4]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    from podtpu_torch.parallel import dryrun, mesh

    mesh.join("gloo", torch.device("cpu"), rank, world, f"file://{store}")
    if argv[4:] == ["four"]:
        try:
            out = flatten("four", four_run(inputs(), seeded_flat(
                yolo_cfg(), 3), rank), {})
        finally:
            mesh.shutdown()
        np.savez(out_path, **out)
        return
    flat, flat_v1 = seeded_flat(yolo_cfg(), 3), seeded_flat(yolov1_cfg(), 4)
    x = inputs()
    rows = slice(rank * B // world, (rank + 1) * B // world)
    shard = mesh.shard_batch
    out: dict = {}
    try:
        flatten("bn", bn_run(x, rows), out)
        flatten("stem", stem_run(x, rows), out)
        dp = steps_run(yolo_cfg(), flat, [batch(x, 0)], shard)
        fsdp = steps_run(yolo_cfg(), flat, [batch(x, 0)], shard, fsdp=True)
        fsdp["vs_dp"] = closeness(fsdp["flat"][0], dp["flat"][0])
        opts = [batch(x, 0), batch(x, 1), nan_batch(x)]
        o_fsdp = steps_run(options_cfg(), flat, opts, shard, fsdp=True,
                           keep=(1, 2))
        # the step with a NaN in the second rank's rows changed nothing
        o_fsdp["nan_step_unchanged"] = digest(o_fsdp["flat"].pop(2)) == \
            digest(o_fsdp["flat"][1])
        aug = steps_run(yolo_cfg(device_augment=True), flat, [batch(x, 1)],
                        shard)
        v1 = steps_run(yolov1_cfg(), flat_v1, [batch(x, 0)], shard)
        runs = {"dp": (dp, flat), "fsdp": (fsdp, None),
                "options_fsdp": (o_fsdp, flat), "augment": (aug, flat),
                "yolov1": (v1, flat_v1)}
        for name, (run, before) in runs.items():
            flats = run.pop("flat")
            for i, f in flats.items():
                run[f"digest{i}"] = digest(f)
                # rank 0's weights (the ranks' are held equal by digest), as
                # their move from the step's start
                if rank == 0 and before is not None:
                    run[f"flat{i}"] = compact(f, before)
            if "ema" in run:
                run["ema_digest"] = digest(run["ema"])
                run["ema"] = compact(run["ema"], run.pop("ema0"))
            flatten(name, run, out)
        flatten("stats", stats_run(yolo_cfg(), flat, shard(batch(x, 2))), out)
        flatten("dropout", dropout_run(x, rows), out)
        flatten("retina", retina_run(x, rows), out)
        d = dryrun.run_checks(torch.device("cpu"))
        flatten("dryrun", {k: v for k, v in d.items()
                           if not k.endswith("_weights")}, out)
        flatten("layouts", layouts_run(x, flat, rank), out)
    finally:
        mesh.shutdown()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
