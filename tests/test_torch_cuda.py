"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a card they skip. This file imports neither JAX nor
podtpu, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import re

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


@pytest.mark.cuda
@pytest.mark.parametrize("hsv", ["exact", "approx"])
def test_device_augment_on_the_card_matches_the_cpu(cuda, hsv):
    """The draw on the card (no host tensor, no sync), the apply there
    against the same draws on the CPU: the exact path bit for bit, the
    approximate one to 1e-5; the warp to 1e-4 with TF32 off."""
    from podtpu_torch.data import device_aug as T

    r = np.random.default_rng(5)
    img = torch.from_numpy(r.integers(0, 256, (8, 96, 96, 3), dtype=np.uint8))
    annot = torch.from_numpy(np.concatenate([
        r.uniform(0.1, 0.9, (8, 6, 5)), -np.ones((8, 2, 5))], 1)
        .astype(np.float32))
    geom = torch.tensor([[1.2, 1.2, -5.0, -3.0]] * 4
                        + [[0.8, 0.7, 6.0, 4.5]] * 4)
    gen = torch.Generator(device=cuda).manual_seed(3)
    gains, flips = T.draw_augment(8, gen)
    assert gains.device.type == flips.device.type == "cuda"
    got = T.apply_augment(img.to(cuda), annot.to(cuda), gains, flips, hsv)
    want = T.apply_augment(img, annot, gains.cpu(), flips.cpu(), hsv)
    if hsv == "exact":
        assert torch.equal(got[0].cpu(), want[0])
    else:
        assert (got[0].cpu() - want[0]).abs().max() <= 1e-5
    assert torch.equal(got[1].cpu(), want[1])
    assert not torch.backends.cuda.matmul.allow_tf32
    x = img.float() / 255.0
    warp = T.separable_affine(x.to(cuda), geom.to(cuda))
    assert (warp.cpu() - T.separable_affine(x, geom)).abs().max() <= 1e-4


@pytest.mark.cuda
def test_async_checkpoint_of_a_card_state(cuda, tmp_path):
    """An async save copies the card's tensors into pinned host buffers
    before it returns: an in-place update after it does not reach the
    file, which restores to the state as it was."""
    from podtpu_torch.train.state import TrainState
    from podtpu_torch.train.trainer import CheckpointIO

    torch.manual_seed(0)
    model = torch.nn.Conv2d(3, 8, 3).to(cuda)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(2, 3, 8, 8, device=cuda)).sum().backward()
    opt.step()
    state = TrainState(model, opt, lambda s: 0.1, step=7)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    io = CheckpointIO(str(tmp_path), async_save=True)
    io.save("last", state)
    assert all(b.is_pinned() for b in io._host["buffers"])
    with torch.no_grad():
        model.weight.add_(1.0)
    io.wait()
    other = torch.nn.Conv2d(3, 8, 3).to(cuda)
    fresh = TrainState(other, torch.optim.SGD(other.parameters(), lr=0.1,
                                              momentum=0.9), lambda s: 0.1)
    io.restore(str(tmp_path / "last"), fresh)
    assert fresh.step == 7
    for k, v in fresh.model.state_dict().items():
        assert v.device.type == "cuda" and torch.equal(v, before[k]), k


_CONV_KERNEL = re.compile(r"conv|gemm|xmma|cudnn|cutlass|dgrad|wgrad|nchw|nhwc",
                          re.IGNORECASE)


@pytest.mark.cuda
def test_step_profile_splits_the_backward_on_the_card(cuda):
    """The step profile's attribution on the card (each kernel through the
    operator that launched it, and the fallback) against a split found
    without it, on a ConvBnAct stack trained in float32: the backward's
    kernels are the ones between the host's pauses after the forward and
    after the backward, and among them the convolution kernels are found
    by name, the ReLU's by its threshold kernel, and the rest are the
    autograd of BatchNormMixed (the loss, a sum, launches one
    one-element fill). Each row of (c) holds its share to 5% of the
    backward's device time."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    from podtpu_torch.models.layers import ConvBnAct
    from podtpu_torch.utils.step_profile import (
        _device_events,
        _ModuleRanges,
        attribute,
    )

    torch.manual_seed(0)
    model = torch.nn.Sequential(
        ConvBnAct(3, 32), ConvBnAct(32, 64, strides=2), ConvBnAct(64, 64),
        ConvBnAct(64, 64)).to(cuda).train()
    x = torch.randn(8, 3, 128, 128, device=cuda)

    def step():
        with record_function("forward"):
            y = model(x)
        with record_function("loss"):
            loss = y.sum()
        torch.cuda.synchronize()
        time.sleep(0.02)
        with record_function("backward"):
            loss.backward()
        torch.cuda.synchronize()
        time.sleep(0.02)
        model.zero_grad(set_to_none=True)

    for _ in range(2):
        step()
    ranges = _ModuleRanges(model)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
    ranges.remove()
    results = prof.profiler.kineto_results
    views = attribute(prof.events(), results.events(),
                      results.trace_start_ns())

    # the device's work in runs split by the pauses: forward, backward, ...
    dev = sorted(_device_events(results.events(), results.trace_start_ns()),
                 key=lambda d: d[1])
    runs, end = [], -np.inf
    for name, start, stop, _ in dev:
        if start - end > 10e3:  # us
            runs.append([])
        runs[-1].append((name, stop - start))
        end = max(end, stop)
    assert len(runs) == 6, [len(r) for r in runs]
    back = [k for r in runs[1::2] for k in r]
    total = sum(us for _, us in back)
    want = {"conv": sum(us for n, us in back if _CONV_KERNEL.search(n)),
            "activation": sum(us for n, us in back if "threshold" in n)}
    want["bn"] = total - want["conv"] - want["activation"]
    got = {k: v * 1e3 for k, v in views["backward_by_node_ms"].items()}
    detail = {"want_us": want, "got_us": got, "total_us": total,
              "fallback_ms": views["fallback_ms"],
              "kernels": sorted({n[:90] for n, _ in back})}
    assert views["coverage"] >= 0.99, detail
    assert views["parts_ms"]["backward"] * 1e3 == pytest.approx(
        total, rel=0.01), detail
    assert want["conv"] > 0 and want["bn"] > 0, detail
    for row in ("conv", "activation", "bn"):
        assert abs(got.get(row, 0.0) - want[row]) <= 0.05 * total, \
            (row, detail)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{"merge": True}, {"agnostic": True},
                                  {"classes": (0, 14)}])
def test_nms_options_through_the_kernel_match_the_cpu(cuda, opts):
    """Merge (on the kernel's keep mask over dense overlapping boxes),
    agnostic and the class filter on the card against the same call on the
    CPU (the plain suppression): valid masks exactly, merged boxes within
    float32 rounding of the [K, K] @ [K, 4] product (TF32 off)."""
    from podtpu_torch.ops.nms import batched_class_aware_nms

    r = np.random.default_rng(11)
    boxes = np.zeros((8, 2000, 6), np.float32)
    boxes[..., 0:2] = r.uniform(100, 140, (8, 2000, 2))
    boxes[..., 2:4] = r.uniform(40, 80, (8, 2000, 2))
    boxes[..., 4] = r.uniform(0, 1, (8, 2000))
    boxes[..., 5] = r.integers(0, 20, (8, 2000))
    boxes = torch.from_numpy(boxes)
    before = greedy_suppress.launches
    got = batched_class_aware_nms(boxes.to(cuda), **opts)
    torch.cuda.synchronize()
    assert greedy_suppress.launches == before + 1
    want = batched_class_aware_nms(boxes, **opts)
    assert torch.equal(got[1].cpu(), want[1]) and bool(want[1].any())
    assert (got[0].cpu() - want[0]).abs().max() <= 1e-3


@pytest.mark.cuda
def test_multilabel_serving_through_the_kernel(cuda):
    """Multi-label decoding of YOLOv3 heads (20 classes: N = 84 x 3 x 20
    at 64 px) and NMS on the card against the CPU."""
    from podtpu_torch.ops.decode import decode_yolov3
    from podtpu_torch.ops.nms import batched_class_aware_nms

    anchors = [[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119],
               [116, 90], [156, 198], [373, 326]]
    r = np.random.default_rng(12)
    heads = [torch.from_numpy(r.normal(0, 2, (4, s, s, 75))
                              .astype(np.float32)) for s in (8, 4, 2)]
    cpu = decode_yolov3(heads, 20, anchors, 64, multi_label=True)
    card = decode_yolov3([h.to(cuda) for h in heads], 20, anchors, 64,
                         multi_label=True)
    assert card.shape == (4, 84 * 3 * 20, 6)
    # exp / sigmoid to float32 rounding (boxes up to ~1e3 px)
    assert ((card.cpu() - cpu).abs() <= 1e-4 + 1e-5 * cpu.abs()).all()
    before = greedy_suppress.launches
    got = batched_class_aware_nms(cpu.to(cuda))
    torch.cuda.synchronize()
    assert greedy_suppress.launches == before + 1
    want = batched_class_aware_nms(cpu)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])


@pytest.mark.cuda
def test_rejected_step_leaves_the_card_state_bit_for_bit(cuda):
    """skip_nonfinite on the card: a batch with a NaN pixel leaves the
    parameters, momentum, counts and BN statistics as they were, bit for
    bit, with the stem's kernels launched as on any step."""
    from podtpu_torch.data.loader import pad_annotations
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    anchors = [[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119],
               [116, 90], [156, 198], [373, 326]]
    cfg = {"model": "yolov3", "num_classes": 20, "anchors": anchors,
           "input_size": 64, "compute_dtype": "float32", "max_annots": 8,
           "optimizer": "sgd", "scheduler": None,
           "optimizer_options": {"lr": 1e-3, "momentum": 0.9,
                                 "nesterov": True, "weight_decay": 5e-4,
                                 "skip_nonfinite": 2}}
    torch.manual_seed(0)
    state = create_train_state(cfg, cuda)
    step = make_train_step(cfg)
    r = np.random.default_rng(0)
    img = torch.from_numpy(r.random((2, 64, 64, 3), np.float32)).to(cuda)
    annot = torch.from_numpy(pad_annotations(
        [np.array([[0.5, 0.5, 0.3, 0.4, 3]], np.float32)] * 2, 8)).to(cuda)
    state, _ = step(state, {"img": img, "annot": annot})
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    mom = [s["momentum_buffer"].clone() for s in state.optimizer.state.values()]
    bad = img.clone()
    bad[0, 3, 3, 0] = float("nan")
    before = dict(sk.stem_fused.launches)
    state, m = step(state, {"img": bad, "annot": annot})
    torch.cuda.synchronize()
    assert not torch.isfinite(m["loss"])
    assert all(v == before[k] + 1 for k, v in sk.stem_fused.launches.items())
    assert (state.step, state.count, state.total_notfinite) == (2, 1, 1)
    assert all(torch.equal(v, state.model.state_dict()[k])
               for k, v in sd.items())
    assert all(torch.equal(a, s["momentum_buffer"]) for a, s in
               zip(mom, state.optimizer.state.values()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,o,k,s", [
    (2, 3, 64, 32, 3, 1),      # the stem: depth 27 padded to 32
    (1, 32, 16, 20, 3, 2),     # a stride-2 conv; 20 outputs padded to 24
    (1, 1024, 2, 512, 1, 1),   # 1x1 over 1,024 channels: 4 rows padded
    (2, 512, 13, 1024, 3, 1),  # a 3x3 over 512 channels at 13 x 13
])
def test_int8_conv_is_exact_on_the_card(cuda, b, c, h, o, k, s):
    """The im2col + ``_int_mm`` route against the plain float64 version on
    the same int8 operands: int32 accumulators equal, at the extremes
    (+-127 everywhere) too."""
    from podtpu_torch.ops.int8_conv import (
        int8_conv2d,
        int8_conv2d_reference,
    )

    g = torch.Generator().manual_seed(b * c + o)
    x = torch.randint(-127, 128, (b, c, h, h), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (o, c, k, k), dtype=torch.int8, generator=g)
    for xx, ww in ((x, w), (torch.full_like(x, 127), torch.full_like(w, -127))):
        got = int8_conv2d(xx.to(cuda), ww.to(cuda), s, (k - 1) // 2)
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), int8_conv2d_reference(xx, ww, s,
                                                            (k - 1) // 2))


@pytest.mark.cuda
def test_exported_program_launches_the_suppression_kernel(cuda, tmp_path):
    """A ``torch.export`` program holding the registered operator, saved
    and loaded: one kernel launch a call, the plain version's keep mask."""
    from podtpu_torch.export import program

    rng = np.random.default_rng(3)
    boxes, valid = _offset_boxes(rng, 4, 512)

    class Suppress(torch.nn.Module):
        def forward(self, b, v):
            return torch.ops.podtpu_torch.greedy_suppress(b, v, 0.45)

    ep = torch.export.export(Suppress(), (boxes.to(cuda), valid.to(cuda)))
    torch.export.save(ep, str(tmp_path / "s.pt2"))
    module = program.load_program(str(tmp_path / "s.pt2")).module()
    before = greedy_suppress.launches
    keep = module(boxes.to(cuda), valid.to(cuda))
    assert greedy_suppress.launches == before + 1
    assert torch.equal(keep.cpu(), greedy_suppress_reference(boxes, valid,
                                                             0.45))


@pytest.mark.cuda
def test_int8_tflite_reader_on_the_card_gives_the_cpu_codes(cuda, tmp_path):
    """A YOLOv3 int8 serving file at 64 px (seeded weights, calibrated on
    two batches): the reader on the card makes every int8 tensor the CPU
    reader makes, bit for bit (``torch._int_mm`` against the float64
    product), the same valid masks, each detection paired with one of the
    CPU's (score within 1e-4, box within 1e-4 of its size), and one
    suppression launch a call."""
    from podtpu_torch.export.tflite import export_tflite, load_tflite
    from podtpu_torch.models.factory import build_model

    cfg = dict(model="yolov3", num_classes=3, input_size=64,
               compute_dtype="float32", conf_threshold=0.25,
               nms_iou_threshold=0.45, top_k_candidates=512,
               max_detections=100, anchors=[
                   [10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                   [59, 119], [116, 90], [156, 198], [373, 326]])
    torch.manual_seed(5)
    model = build_model(cfg, "cpu").eval()
    rng = np.random.default_rng(5)
    x, *rep = [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
               for _ in range(3)]
    path = export_tflite(model, cfg, (2, 64, 64, 3),
                         str(tmp_path / "q.tflite"), with_postprocess=True,
                         quantize="int8", rep_batches=rep)
    runs = {}
    for key, dev in (("cpu", "cpu"), ("card", cuda)):
        codes = {}
        before = greedy_suppress.launches
        out = load_tflite(path, dev).run(
            [torch.from_numpy(x)], lambda t, v: codes.__setitem__(t, v.cpu())
            if v.dtype == torch.int8 else None)
        torch.cuda.synchronize()
        runs[key] = (codes, [o.cpu() for o in out],
                     greedy_suppress.launches - before)
    (cc, (cd, cv), _), (gc, (gd, gv), launches) = runs["cpu"], runs["card"]
    assert cc.keys() == gc.keys() and len(cc) > 30
    for t in cc:
        assert torch.equal(cc[t], gc[t]), t
    assert launches == 1
    assert torch.equal(cv, gv)
    # the float decode rounds apart on the two devices (exp, sigmoid), so
    # detections whose scores tie within rounding may come in either order
    for g, c, v in zip(gd, cd, cv):
        free = torch.ones(int(v.sum()), dtype=torch.bool)
        want = c[v].double()
        for row in g[v].double():
            box = ((want[:, :4] - row[:4]).abs()
                   / want[:, :4].abs().clamp_min(1.0)).amax(-1)
            fits = free & (want[:, 5] == row[5]) & (box <= 1e-4) & (
                (want[:, 4] - row[4]).abs() <= 1e-4)
            assert fits.any(), row
            free[int(fits.int().argmax())] = False


@pytest.mark.cuda
def test_savedmodel_reader_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A YOLOv3 float32 serving SavedModel at 64 px (seeded weights, B=2):
    the reader on the card runs the batch's two ``NonMaxSuppressionV5``
    nodes as one suppression launch, and gives the CPU reader's valid
    masks and detections (each paired with one of the CPU's: score within
    1e-4, box within 1e-4 of its size). At these weights many scores tie
    at 0.5: where ``max_detections`` cuts such a run, the two devices may
    keep different members of it, so a detection left unpaired must score
    within 1e-4 of the image's last kept score."""
    from podtpu_torch.export.savedmodel import (
        export_savedmodel,
        load_savedmodel,
    )
    from podtpu_torch.models.factory import build_model

    cfg = dict(model="yolov3", num_classes=3, input_size=64,
               compute_dtype="float32", conf_threshold=0.25,
               nms_iou_threshold=0.45, top_k_candidates=512,
               max_detections=100, anchors=[
                   [10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                   [59, 119], [116, 90], [156, 198], [373, 326]])
    torch.manual_seed(6)
    model = build_model(cfg, "cpu").eval()
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    path = export_savedmodel(model, cfg, (2, 64, 64, 3),
                             str(tmp_path / "s.savedmodel"),
                             with_postprocess=True)
    prog = load_savedmodel(path)
    assert prog.device.type == "cuda"
    before = greedy_suppress.launches
    gd, gv = prog(x)
    torch.cuda.synchronize()
    assert greedy_suppress.launches == before + 1
    cd, cv = load_savedmodel(path, "cpu")(x)
    assert torch.equal(gv.cpu(), cv) and cv.any()
    for g, c, v in zip(gd.cpu(), cd, cv):
        free = torch.ones(int(v.sum()), dtype=torch.bool)
        want = c[v].double()
        alone = []
        for row in g[v].double():
            box = ((want[:, :4] - row[:4]).abs()
                   / want[:, :4].abs().clamp_min(1.0)).amax(-1)
            fits = free & (want[:, 5] == row[5]) & (box <= 1e-4) & (
                (want[:, 4] - row[4]).abs() <= 1e-4)
            if not fits.any():
                alone.append(float(row[4]))
                continue
            free[int(fits.int().argmax())] = False
        alone += want[free, 4].tolist()
        if alone:
            cut = float(want[:, 4].min())
            assert all(abs(a - cut) <= 1e-4 for a in alone), (alone, cut)
