"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a card they skip. This file imports neither JAX nor
podtpu, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from podtpu_torch.ops.boxes import pairwise_iou
from podtpu_torch.ops.kernels import stem_kernel as sk
from podtpu_torch.ops.kernels.nms_kernel import (
    greedy_suppress,
    greedy_suppress_reference,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _offset_boxes(rng, b, k):
    """Score-sorted class-offset xyxy boxes (20 classes at podtpu's stride)
    with a valid prefix of random length per image."""
    c = rng.uniform(0, 300, (b, k, 2))
    wh = rng.uniform(5, 120, (b, k, 2))
    cls = rng.integers(0, 20, (b, k, 1)).astype(np.float32)
    xyxy = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    boxes = (xyxy + cls * np.float32(16385.0)).astype(np.float32)
    valid = np.arange(k)[None, :] < rng.integers(0, k + 1, (b, 1))
    return torch.from_numpy(boxes), torch.from_numpy(valid)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,none_valid", [
    (8, 512, False), (64, 512, False), (3, 4096, False), (2, 1, False),
    (2, 8192, False),                     # MAX_K: 128 words a row
    (4, 300, False), (4, 513, False),     # ragged last word
    (8, 512, True),                       # nothing valid: the scan ends at once
    (1, 512, False), (1, 512, True),      # the per-image CLIs' batch
    (8, 49, False), (64, 49, False),      # YOLOv1: 7x7 cells, a partial word
])
def test_suppress_kernel_matches_reference(cuda, b, k, none_valid):
    boxes, valid = _offset_boxes(np.random.default_rng(k + b), b, k)
    if none_valid:
        valid = torch.zeros_like(valid)
    boxes, valid = boxes.to(cuda), valid.to(cuda)
    before = greedy_suppress.launches
    got = greedy_suppress(boxes, valid, 0.45)
    torch.cuda.synchronize()
    assert greedy_suppress.launches == before + 1
    assert torch.equal(got, greedy_suppress_reference(boxes, valid, 0.45))


@pytest.mark.cuda
def test_suppress_kernel_is_exact_at_the_threshold(cuda):
    """The threshold set to a pair's float32 IoU and to the floats either
    side of it: the kernel's IoU and compare decide as the plain version's
    (kept, removed, kept); one rounding apart (an FMA, a fast division)
    flips them."""
    rng = np.random.default_rng(7)
    valid = torch.ones((1, 2), dtype=torch.bool, device=cuda)
    for _ in range(50):
        a, _ = _offset_boxes(rng, 1, 1)
        b = a + torch.from_numpy(rng.uniform(-20, 20, (1, 1, 4)).astype(
            np.float32))
        boxes = torch.cat([a, b], 1).to(cuda)
        iou = np.float32(pairwise_iou(boxes, boxes)[0, 0, 1].item())
        for t, want in ((iou, True), (np.nextafter(iou, np.float32(-1)), False),
                        (np.nextafter(iou, np.float32(2)), True)):
            got = greedy_suppress(boxes, valid, float(t))
            assert torch.equal(got, greedy_suppress_reference(boxes, valid,
                                                              float(t)))
            assert bool(got[0, 1]) is want


@pytest.mark.cuda
def test_suppress_kernel_rejects_non_contiguous(cuda):
    boxes = torch.zeros(2, 4, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        greedy_suppress(boxes, torch.ones(2, 8, dtype=torch.bool,
                                          device=cuda), 0.45)


def _stem_operands(b, h, w, dtype, dev, seed=0):
    r = np.random.default_rng(seed)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = as_t(r.random((b, h, w, 3))).to(dtype)
    wt = as_t(r.normal(0.0, np.sqrt(2.0 / 27), (3, 3, 3, 32)))
    scale, bias = as_t(r.uniform(0.5, 1.5, 32)), as_t(r.normal(0, 0.1, 32))
    g = as_t(r.normal(0, 1, (b, h // 2, w // 2, 32))).to(dtype)
    return x, wt, scale, bias, g


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", [(2, 64, 64), (2, 416, 416), (3, 40, 70),
                                   (2, 448, 448)])  # YOLOv1: 14 column tiles
def test_stem_kernels_match_plain_versions(cuda, dtype, b, h, w):
    """Each kernel against its plain version on the same operands: float32
    to 1e-4 of the result's scale (TF32 off for the plain conv); bf16 sums
    to 1e-3, the pooled output on all but 1e-3 of its elements within one
    bf16 ulp at its scale, the backward by direction."""
    torch.backends.cudnn.allow_tf32 = False
    x, wt, scale, bias, g = _stem_operands(b, h, w, dtype, cuda)
    n = b * h * w
    before = dict(sk.stem_fused.launches)
    s_k, s_r = sk.stem_stats(x, wt), sk.stem_stats_reference(x, wt)
    assert torch.equal(s_k, sk.stem_stats(x, wt))  # no atomics: same bits
    mean = s_r[0] / n
    var = (s_r[1] / n - mean * mean).clamp_min(0.0)
    rinv = torch.rsqrt(var + 1e-5)
    inv = rinv * scale
    mul, add = inv.to(dtype).float(), (bias - mean * inv).to(dtype).float()
    p_k = sk.stem_emit(x, wt, mul, add)
    p_r = sk.stem_emit_reference(x, wt, mul, add)
    u_k = sk.stem_bwd_sums(x, wt, mul, add, mean, rinv, g)
    u_r = sk.stem_bwd_sums_reference(x, wt, mul, add, mean, rinv, g)
    c0, c1 = u_r[0] / n, u_r[1] / n
    d_k = sk.stem_bwd_dw(x, wt, mul, add, mean, rinv, inv, c0, c1, g)
    d_r = sk.stem_bwd_dw_reference(x, wt, mul, add, mean, rinv, inv, c0, c1, g)
    # fixed-order reductions and mma's fixed accumulation order: same bits
    assert torch.equal(u_k, sk.stem_bwd_sums(x, wt, mul, add, mean, rinv, g))
    assert torch.equal(d_k, sk.stem_bwd_dw(x, wt, mul, add, mean, rinv, inv,
                                           c0, c1, g))
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in sk.stem_fused.launches.items()} == {
        "stats": 2, "emit": 1, "bwd_sums": 2, "bwd_dw": 2}
    assert p_k.shape == (b, h // 2, w // 2, 32) and p_k.dtype == dtype
    diff = (p_k.float() - p_r.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5
        assert max(_rel(s_k, s_r), _rel(u_k, u_r), _rel(d_k, d_r)) <= 1e-4
    else:
        assert float((diff > 0).float().mean()) <= 1e-3
        assert float(diff.max()) <= 2.0 ** -7 * float(p_r.float().abs().max())
        assert _rel(s_k, s_r) <= 1e-3
        for a, r in ((u_k, u_r), (d_k, d_r)):
            a, r = a.double().flatten(), r.double().flatten()
            assert float(a @ r / (a.norm() * r.norm())) >= 0.995


def _bwd_vectors(x, wt, scale, bias, g):
    n = x.shape[0] * x.shape[1] * x.shape[2]
    s_r = sk.stem_stats_reference(x, wt)
    mean = s_r[0] / n
    var = (s_r[1] / n - mean * mean).clamp_min(0.0)
    rinv = torch.rsqrt(var + 1e-5)
    inv = rinv * scale
    mul = inv.to(x.dtype).float()
    add = (bias - mean * inv).to(x.dtype).float()
    u_r = sk.stem_bwd_sums_reference(x, wt, mul, add, mean, rinv, g)
    return (mul, add, mean, rinv, inv, u_r[0] / n, u_r[1] / n), u_r


def _cos(a, r):
    a, r = a.double().flatten(), r.double().flatten()
    return float(a @ r / (a.norm() * r.norm()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 64, 64), (2, 416, 416), (3, 40, 70),
                                   (8, 416, 416)])
def test_tensor_core_kernels_share_one_conv(cuda, b, h, w):
    """bf16: all four kernels run one conv core, so forward and backward
    agree exactly. With a cotangent of ones bwd_sums' first row counts the
    pool windows of a channel whose max is positive, and those are the
    windows emit wrote as positive, in all 32 channels. At (3, 40, 70) the
    tiles are ragged (the conv beyond the border must stay out of stats and
    out of the output); at (8, 416, 416) a block walks several tiles (2,704
    tiles over one wave of blocks), so both load stages, the output stage
    and the sums that live in registers across tiles are exercised. Each
    kernel gives the same bits twice and stays within the card checks'
    limits of its plain version."""
    torch.backends.cudnn.allow_tf32 = False
    x, wt, scale, bias, g = _stem_operands(b, h, w, torch.bfloat16, cuda, 1)
    vecs, u_r = _bwd_vectors(x, wt, scale, bias, g)
    mul, add, mean, rinv = vecs[:4]
    before = dict(sk.stem_fused.launches)
    s_k = sk.stem_stats(x, wt)
    p_k = sk.stem_emit(x, wt, mul, add)
    u_k = sk.stem_bwd_sums(x, wt, mul, add, mean, rinv, g)
    d_k = sk.stem_bwd_dw(x, wt, *vecs, g)
    positive = sk.stem_bwd_sums(x, wt, mul, add, mean, rinv,
                                torch.ones_like(g))[0]
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in sk.stem_fused.launches.items()} == {
        "stats": 1, "emit": 1, "bwd_sums": 2, "bwd_dw": 1}
    assert torch.equal(positive, (p_k > 0).sum(dim=(0, 1, 2)).float())
    assert torch.equal(s_k, sk.stem_stats(x, wt))
    assert torch.equal(p_k, sk.stem_emit(x, wt, mul, add))
    assert torch.equal(u_k, sk.stem_bwd_sums(x, wt, mul, add, mean, rinv, g))
    assert torch.equal(d_k, sk.stem_bwd_dw(x, wt, *vecs, g))
    assert _rel(s_k, sk.stem_stats_reference(x, wt)) <= 1e-3
    p_r = sk.stem_emit_reference(x, wt, mul, add)
    diff = (p_k.float() - p_r.float()).abs()
    assert float((diff > 0).float().mean()) <= 1e-3
    assert float(diff.max()) <= 2.0 ** -7 * float(p_r.float().abs().max())
    d_r = sk.stem_bwd_dw_reference(x, wt, *vecs, g)
    for got, want in ((u_k, u_r), (d_k, d_r)):
        assert _rel(got, want) <= 2e-3
        assert _cos(got, want) >= 0.995


@pytest.mark.cuda
def test_kernels_reject_misaligned_tensors(cuda):
    x, wt, scale, bias, g = _stem_operands(2, 16, 16, torch.bfloat16, cuda)
    vecs, _ = _bwd_vectors(x, wt, scale, bias, g)
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda)
    off = flat[1:].view_as(x).copy_(x)    # contiguous, 2 bytes off alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        sk.stem_bwd_sums(off, wt, *vecs[:4], g)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sk.stem_stats(off, wt)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sk.stem_emit(off, wt, *vecs[:2])


def _yolo64_bf16() -> dict:
    """YOLOv3 at 64 px in bf16 with the flagship recipe's optimizer."""
    anchors = [[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119],
               [116, 90], [156, 198], [373, 326]]
    return dict(model="yolov3", num_classes=20, anchors=anchors,
                input_size=64, compute_dtype="bfloat16", optimizer="sgd",
                optimizer_options={"lr": 1e-3, "momentum": 0.9,
                                   "nesterov": True, "weight_decay": 1e-2})


@pytest.mark.cuda
def test_train_step_launches_each_stem_kernel_once(cuda):
    from podtpu_torch.data.loader import pad_annotations
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    cfg = _yolo64_bf16()
    state = create_train_state(cfg, cuda)
    step = make_train_step(cfg)
    r = np.random.default_rng(0)
    batch = {"img": torch.from_numpy(r.integers(0, 256, (2, 64, 64, 3),
                                                dtype=np.uint8)).to(cuda),
             "annot": torch.from_numpy(pad_annotations(
                 [np.array([[0.5, 0.5, 0.3, 0.4, 3]], np.float32)] * 2,
                 8)).to(cuda)}
    before = dict(sk.stem_fused.launches)
    for _ in range(2):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"])
    assert {k: v - before[k] for k, v in sk.stem_fused.launches.items()} == {
        k: 2 for k in before}


@pytest.mark.cuda
def test_stats_step_launches_only_the_forward_kernels(cuda):
    """SWA's BN-statistics step in bf16: the stem's two forward kernels once
    each, its backward never, every BN layer's statistics finite, and the
    state (buffers, parameters, modes) left bit for bit."""
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_stats_step

    cfg = _yolo64_bf16()
    state = create_train_state(cfg, cuda)
    state.model.eval()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    img = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8)).to(cuda)
    launches = dict(sk.stem_fused.launches)
    raw = make_stats_step(cfg)(state, {"img": img})
    torch.cuda.synchronize()
    assert {k: v - launches[k] for k, v in sk.stem_fused.launches.items()} == {
        "stats": 1, "emit": 1, "bwd_sums": 0, "bwd_dw": 0}
    assert set(raw) == {k for k in before if "running_" in k}
    assert all(torch.isfinite(v).all() and v.device.type == "cuda"
               for v in raw.values())
    assert not any(m.training for m in state.model.modules())
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


_FAMILIES = {
    "yolov1": dict(num_boxes=2, input_size=96),
    "yolov2": dict(scaled_anchors=[[1.3221, 1.73145], [3.19275, 4.00944],
                                   [5.05587, 8.09892], [9.47112, 4.84053],
                                   [11.2364, 10.0071]], input_size=64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(_FAMILIES))
def test_family_steps_launch_the_kernels(cuda, model):
    """YOLOv1 and YOLOv2 in bf16: each train step launches every stem
    kernel once; the serving graph launches suppression once a batch, and
    its keep masks on the family's own candidates equal the plain
    version's."""
    from podtpu_torch.data.loader import pad_annotations
    from podtpu_torch.ops.nms import _select_candidates
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_decoder, make_serve_fn
    from podtpu_torch.train.steps import make_train_step

    cfg = dict(model=model, num_classes=20, compute_dtype="bfloat16",
               optimizer="sgd", optimizer_options={
                   "lr": 1e-3, "momentum": 0.9, "nesterov": True,
                   "weight_decay": 5e-3}, **_FAMILIES[model])
    size = cfg["input_size"]
    state = create_train_state(cfg, cuda)
    r = np.random.default_rng(0)
    img = torch.from_numpy(r.integers(0, 256, (2, size, size, 3),
                                      dtype=np.uint8)).to(cuda)
    batch = {"img": img, "annot": torch.from_numpy(pad_annotations(
        [np.array([[0.5, 0.5, 0.3, 0.4, 3]], np.float32)] * 2, 8)).to(cuda)}
    before = dict(sk.stem_fused.launches)
    step = make_train_step(cfg)
    for _ in range(2):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"])
    assert {k: v - before[k] for k, v in sk.stem_fused.launches.items()} == {
        k: 2 for k in before}

    model_ = state.model.eval()
    launches = greedy_suppress.launches
    x = img.float() / 255.0
    dets, valid = make_serve_fn(cfg, model_)(x)
    torch.cuda.synchronize()
    assert greedy_suppress.launches == launches + 1
    assert dets.device.type == "cuda" and torch.isfinite(dets).all()
    with torch.inference_mode():
        _, ok, boxes = _select_candidates(make_decoder(cfg)(model_(x)), 0.25,
                                          512)
        boxes = boxes.contiguous()
        assert boxes.shape[1] == (49 if model == "yolov1" else 20)
        assert torch.equal(greedy_suppress(boxes, ok, 0.45),
                           greedy_suppress_reference(boxes, ok, 0.45))


@pytest.mark.cuda
def test_retinanet_serving_and_clipped_step_on_the_card(cuda):
    """RetinaNet at 128 px in bf16 (3,069 anchors): the serving graph
    launches suppression once a batch and its keep masks on the model's own
    candidates (K = 512) equal the plain version's; a train step of the
    recipe (clip_grad_norm 10) launches no stem kernel, gives a finite loss
    and leaves the global gradient norm at most 10."""
    from podtpu_torch.data.loader import pad_annotations
    from podtpu_torch.ops.nms import _select_candidates
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import (
        make_decoder,
        make_serve_fn,
        make_train_step,
    )

    cfg = dict(model="retinanet", num_classes=20, input_size=128,
               compute_dtype="bfloat16", optimizer="sgd",
               optimizer_options={"lr": 1e-2, "momentum": 0.9,
                                  "nesterov": True, "weight_decay": 1e-4,
                                  "clip_grad_norm": 10.0})
    torch.manual_seed(0)
    state = create_train_state(cfg, cuda)
    with torch.no_grad():  # no prior: candidates pass the threshold
        state.model.cls_subnet.pred.bias.zero_()
    r = np.random.default_rng(0)
    img = torch.from_numpy(r.integers(0, 256, (2, 128, 128, 3),
                                      dtype=np.uint8)).to(cuda)
    batch = {"img": img, "annot": torch.from_numpy(pad_annotations(
        [np.array([[0.5, 0.5, 0.3, 0.4, 3]], np.float32)] * 2, 8)).to(cuda)}
    before = dict(sk.stem_fused.launches)
    norms = []  # the gradients' norm as the optimizer is handed them
    state.optimizer.register_step_pre_hook(lambda *_: norms.append(float(
        torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in state.model.parameters()])))))
    state, m = make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"]) and state.step == 1
    assert sk.stem_fused.launches == before
    assert len(norms) == 1 and norms[0] <= 10.0 * (1 + 1e-5), norms

    model = state.model.eval()
    launches = greedy_suppress.launches
    x = img.float() / 255.0
    dets, valid = make_serve_fn(cfg, model)(x)
    torch.cuda.synchronize()
    assert greedy_suppress.launches == launches + 1
    assert dets.device.type == "cuda" and torch.isfinite(dets).all()
    with torch.inference_mode():
        _, ok, boxes = _select_candidates(make_decoder(cfg)(model(x)), 0.25,
                                          512)
        boxes = boxes.contiguous()
        assert boxes.shape[1] == 512 and bool(ok.any())
        assert torch.equal(greedy_suppress(boxes, ok, 0.45),
                           greedy_suppress_reference(boxes, ok, 0.45))
