"""Video -> video inference (the port's ``make_video.py``;
make_video_yolov4-tiny.py:19-108 analog): read frames, run the eval step,
rescale boxes to the frame's size, draw, write out (``mp4v``).

    python -m podtpu_torch.cli.make_video --cfg ... --ckpt ... \\
        --input in.mp4 --output out.mp4 [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import time

import cv2
import numpy as np

from podtpu_torch.cli import Detector, add_common_args, class_names
from podtpu_torch.config import get_configs
from podtpu_torch.utils.viz import draw_boxes


def run(cfg: dict, ckpt: str | None, input_path: str, output_path: str,
        device=None, artifact: str | None = None) -> dict:
    """Returns ``{"frames", "seconds", "fps"}``. Raises when the input
    cannot be read or the writer cannot be opened."""
    detect = Detector(cfg, ckpt, artifact, device)
    names = class_names(cfg)
    size = cfg["input_size"]
    with contextlib.ExitStack() as stack:
        cap = cv2.VideoCapture(input_path)
        stack.callback(cap.release)
        if not cap.isOpened():
            raise FileNotFoundError(input_path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 30
        w0 = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h0 = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        writer = cv2.VideoWriter(
            output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w0, h0)
        )
        stack.callback(writer.release)
        if not writer.isOpened():
            raise RuntimeError(f"cv2.VideoWriter (mp4v) could not open "
                               f"{output_path}")

        n = 0
        t0 = time.perf_counter()
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            inp = cv2.resize(frame, (size, size),
                             interpolation=cv2.INTER_LINEAR)
            inp = cv2.cvtColor(inp, cv2.COLOR_BGR2RGB).astype(
                np.float32) / 255.0
            dets = detect(inp[None]).copy()
            if len(dets):
                dets[:, [0, 2]] *= w0 / size
                dets[:, [1, 3]] *= h0 / size
            writer.write(draw_boxes(frame, dets, names, color=(0, 255, 0)))
            n += 1
    dt = time.perf_counter() - t0
    print(f"{n} frames in {dt:.1f}s ({n / dt:.1f} fps) -> {output_path}")
    return {"frames": n, "seconds": dt, "fps": n / dt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap, "run an exported serving artifact")
    ap.add_argument("--input", required=True, type=str)
    ap.add_argument("--output", required=True, type=str)
    args = ap.parse_args(argv)
    return run(get_configs(args.cfg), args.ckpt, args.input, args.output,
               device=args.device, artifact=args.artifact)


if __name__ == "__main__":
    main()
