"""Checkpoint converters (the port's ``convert_checkpoint.py``;
lightning2torch.py analog plus the reference's torch weights).

* a checkpoint directory (``state.pt``) -> a weights-only ``.npz`` in
  ``podtpu``'s flat layout (the ``strip_optimizer`` path; ``--use-ema``
  takes the EMA shadow);
* a ``.npz`` -> a fresh checkpoint directory (``--out DIR``, written as
  ``DIR/converted``);
* ``--from-torch``: a reference ``.pt`` state_dict or Lightning ``.ckpt``
  -> ``.npz`` (``export/torch_port.py``), so a reference-trained model is
  scored by the port;
* ``--to-torch``: a checkpoint or ``.npz`` -> a reference-layout ``.pt``
  that loads with ``load_state_dict(strict=True)``.

    python -m podtpu_torch.cli.convert_checkpoint --cfg ... \\
        --ckpt saved/.../checkpoints/best --out weights.npz [--device cpu]
    python -m podtpu_torch.cli.convert_checkpoint --cfg configs/yolov3_voc.yaml \\
        --from-torch epoch=189.ckpt --out yolov3_voc.npz
    python -m podtpu_torch.cli.convert_checkpoint --cfg configs/yolov3_voc.yaml \\
        --ckpt saved/.../checkpoints/best --to-torch out.pt
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from podtpu_torch.config import get_configs


def torch_file_to_npz(path: str, model_name: str, out: str) -> str:
    """Reference ``.pt`` / Lightning ``.ckpt`` -> ``podtpu``-layout
    weights ``.npz``."""
    from podtpu_torch.export.torch_port import torch_to_port
    from podtpu_torch.export.weights import flat_from_tensors

    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    np.savez(out, **flat_from_tensors(torch_to_port(sd, model_name)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True, type=str)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--from-torch", type=str, default=None,
                    help="reference torch .pt / lightning .ckpt to import")
    ap.add_argument("--to-torch", type=str, default=None,
                    help="write a reference-layout torch .pt to this path")
    ap.add_argument("--use-ema", action="store_true",
                    help="convert the checkpoint's EMA shadow weights")
    ap.add_argument("--out", type=str, default="pretrained_weights.npz")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu for local runs)")
    args = ap.parse_args(argv)
    cfg = get_configs(args.cfg)

    if args.from_torch:
        out = torch_file_to_npz(args.from_torch, cfg["model"], args.out)
        print(f"wrote podtpu weights npz to {out}")
        return out
    if not args.ckpt:
        raise SystemExit("--ckpt required unless --from-torch is given")

    from podtpu_torch.export.weights import (
        flat_from_state_dict,
        load_npz_weights,
    )
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.trainer import CheckpointIO, restore_weights

    state = create_train_state(cfg, args.device)
    if args.ckpt.endswith(".npz"):
        if args.use_ema:
            raise SystemExit("--use-ema reads a train-state checkpoint (npz "
                             "files are already weights-only)")
        state = load_npz_weights(state, args.ckpt, allow_partial=True)
    else:
        state = restore_weights(args.ckpt, state, use_ema=args.use_ema)

    if args.to_torch:
        from podtpu_torch.export.torch_port import port_to_torch

        torch.save(port_to_torch(state.model.state_dict(), cfg["model"]),
                   args.to_torch)
        print(f"wrote reference-layout torch state_dict to {args.to_torch}")
        return args.to_torch
    if args.ckpt.endswith(".npz"):
        if args.out.endswith(".npz"):
            raise SystemExit(
                "npz -> checkpoint conversion: --out is the checkpoint "
                f"DIRECTORY and must not end in .npz (got '{args.out}')")
        CheckpointIO(args.out).save("converted", state)
        print(f"wrote checkpoint to {args.out}/converted")
        return args.out
    np.savez(args.out, **flat_from_state_dict(state.model))
    print(f"wrote weights-only npz to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
