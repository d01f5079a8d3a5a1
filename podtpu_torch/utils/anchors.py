"""Auto-anchor: k-means + genetic evolution over label width/heights (the
port's copy of ``podtpu/utils/anchors.py``, on host numpy and scipy).

Offline tool with the same role as the reference's ``utils/anchor.py``
(kmeans + 1000-generation GA, BPR check at threshold 0.98 — anchor.py:48-197)
but vectorized numpy throughout: the fitness of an anchor set against N
label boxes is one [N, K] ratio-metric matrix, not a Python loop.

Metric (the darknet/ultralytics one): for each label, against each anchor,
``r = max(w/aw, aw/w, h/ah, ah/h)`` elementwise-max; a label is "covered" if
``1/r > threshold`` for its best anchor. BPR = fraction covered.

CLI: ``python -m podtpu_torch.utils.anchors --cfg configs/x.yaml
[--generations 1000]``.
"""

from __future__ import annotations

import argparse

import numpy as np


def load_label_wh(list_file: str, input_size: int) -> np.ndarray:
    """Collect [N, 2] label widths/heights in input-pixel scale."""
    from podtpu_torch.data.dataset import label_path_for, read_yolo_labels

    with open(list_file, "r") as f:
        paths = [l for l in f.read().splitlines() if l.strip()]
    whs = []
    for p in paths:
        rows = read_yolo_labels(label_path_for(p))
        if len(rows):
            whs.append(rows[:, 3:5] * input_size)
    if not whs:
        return np.zeros((0, 2), np.float32)
    return np.concatenate(whs).astype(np.float32)


def ratio_metric(wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """[N, K] inverse worst-axis ratio in (0, 1]; higher is better."""
    r = wh[:, None, :] / anchors[None, :, :]
    worst = np.maximum(r, 1.0 / r).max(axis=2)
    return 1.0 / worst


def best_possible_recall(wh: np.ndarray, anchors: np.ndarray,
                         threshold: float = 0.25) -> float:
    """Fraction of labels whose best anchor clears 1/threshold worst-ratio
    (darknet convention: threshold 0.25 == 4.0x worst ratio)."""
    best = ratio_metric(wh, anchors).max(axis=1)
    return float((best > threshold).mean())


def anchor_fitness(wh: np.ndarray, anchors: np.ndarray,
                   threshold: float = 0.25) -> float:
    """Mean best metric over covered labels (the GA objective)."""
    best = ratio_metric(wh, anchors).max(axis=1)
    return float((best * (best > threshold)).mean())


def kmeans_anchors(wh: np.ndarray, n: int = 9, seed: int = 0,
                   iters: int = 30) -> np.ndarray:
    """Whitened k-means on label w/h (scipy if available, else Lloyd's)."""
    try:
        from scipy.cluster.vq import kmeans

        std = wh.std(axis=0)
        centers, _ = kmeans(wh / std, n, iter=iters, seed=seed)
        anchors = centers * std
    except Exception:
        rng = np.random.default_rng(seed)
        anchors = wh[rng.choice(len(wh), n, replace=False)].astype(np.float64)
        for _ in range(iters):
            d = ((wh[:, None, :] - anchors[None]) ** 2).sum(-1)
            assign = d.argmin(1)
            for k in range(n):
                sel = wh[assign == k]
                if len(sel):
                    anchors[k] = sel.mean(0)
    return anchors[np.argsort(anchors.prod(axis=1))].astype(np.float32)


def evolve_anchors(
    wh: np.ndarray,
    anchors: np.ndarray,
    generations: int = 1000,
    mutation_p: float = 0.9,
    sigma: float = 0.1,
    threshold: float = 0.25,
    seed: int = 0,
    verbose: bool = False,
) -> np.ndarray:
    """Genetic refinement: mutate, keep improvements (anchor.py:151-187 role)."""
    rng = np.random.default_rng(seed)
    best = anchors.copy().astype(np.float64)
    best_fit = anchor_fitness(wh, best, threshold)
    shape = best.shape
    for g in range(generations):
        mut = np.ones(shape)
        while (mut == 1).all():
            mut = np.where(
                rng.random(shape) < mutation_p,
                np.clip(rng.normal(1.0, sigma, shape), 0.3, 3.0),
                1.0,
            )
        cand = np.clip(best * mut, 2.0, None)
        fit = anchor_fitness(wh, cand, threshold)
        if fit > best_fit:
            best, best_fit = cand, fit
            if verbose:
                print(f"gen {g}: fitness {fit:.4f}")
    order = np.argsort(best.prod(axis=1))
    return best[order].astype(np.float32)


def check_anchors(cfg: dict, bpr_threshold: float = 0.98,
                  generations: int = 1000, verbose: bool = True):
    """BPR check; evolve new anchors if below threshold (anchor.py:64-101)."""
    anchors = np.asarray(
        cfg.get("anchors") or cfg.get("scaled_anchors"), np.float32
    )
    if "scaled_anchors" in cfg and "anchors" not in cfg:
        # v2 stores grid-unit anchors at stride 32
        anchors = anchors * 32.0
    wh = load_label_wh(cfg["train_list"], cfg["input_size"])
    if not len(wh):
        raise ValueError("no labels found")
    bpr = best_possible_recall(wh, anchors)
    if verbose:
        print(f"BPR: {bpr:.4f} over {len(wh)} labels")
    if bpr >= bpr_threshold:
        return anchors
    n = len(anchors)
    if verbose:
        print("BPR below threshold; running kmeans + GA ...")
    new = kmeans_anchors(wh, n)
    new = evolve_anchors(wh, new, generations=generations, verbose=verbose)
    if verbose:
        print(f"new BPR: {best_possible_recall(wh, new):.4f}")
        print("anchors:", np.round(new).astype(int).tolist())
    return new


def main():
    from podtpu_torch.config import get_configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--generations", type=int, default=1000)
    args = ap.parse_args()
    check_anchors(get_configs(args.cfg), generations=args.generations)


if __name__ == "__main__":
    main()
