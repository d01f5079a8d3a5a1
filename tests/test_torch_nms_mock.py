"""The suppression kernels' CUDA source, compiled by g++ as host C++ against
the mock of the CUDA runtime in ``tools/cuda_mock`` and run on CPU threads,
against the plain PyTorch version.

The mock runs one thread per CUDA thread with real barriers and emulates
the ballot and ``cp.async`` (a copy lands only at the wait that covers its
group), so this holds the IoU bitmask's indexing, the scan's order and its
staging of the next word; it says nothing of what nvcc accepts or how fast
the card runs them (``tests/test_torch_cuda.py`` and ``chip_smoke.py`` do).
Keep masks must equal ``greedy_suppress_reference``'s exactly, and two
planted faults must fail. Without g++ the tests skip.
"""

import ctypes
import os
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from podtpu_torch.ops.boxes import pairwise_iou
from podtpu_torch.ops.kernels import nms_kernel as nk
from podtpu_torch.ops.nms import _select_candidates

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "podtpu_torch", "csrc", "nms_suppress.cu")
MOCK = os.path.join(ROOT, "tools", "cuda_mock")
THR = 0.45
# planted faults: (text of the source, what replaces it)
MUTANTS = {
    # the diagonal bit j == i set: a box removes itself
    "diagonal_bit_set": ("c == r && t + 1 > q * kPiece ? t + 1 : q * kPiece",
                         "c == r && t > q * kPiece ? t : q * kPiece"),
    # a word resolved from its highest alive box down, not in index order
    "word_out_of_order": (
        "const int t = __ffsll(static_cast<long long>(left)) - 1;",
        "const int t = 63 - __clzll(static_cast<long long>(left));"),
}


def _build(src_path, out):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels against the CUDA mock")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
                    "-shared", "-fPIC", "-x", "c++", "-I", MOCK, "-o", out,
                    src_path], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    for name, argtypes in nk._ARGTYPES.items():
        fn = getattr(lib, f"podtpu_nms_{name}")
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(SOURCE, str(tmp_path_factory.mktemp("cuda_mock")
                              / "nms_suppress_mock.so"))


def _suppress(lib, boxes, valid, thr=THR):
    b, k = valid.shape
    mask = torch.zeros((b, k, nk.mask_words(k)), dtype=torch.int64)
    keep = torch.zeros((b, k), dtype=torch.bool)
    assert lib.podtpu_nms_suppress(boxes.data_ptr(), valid.data_ptr(),
                                   mask.data_ptr(), keep.data_ptr(), b, k,
                                   thr, None) == 0
    return keep


# ---- cases -------------------------------------------------------------------

def _offset_boxes(rng, b, k, extent=200.0, classes=3, stride=16385.0):
    """[b, k, 4] class-offset xyxy boxes; few classes over a small extent
    overlap often."""
    c = rng.uniform(0, extent, (b, k, 2))
    wh = rng.uniform(5, 120, (b, k, 2))
    cls = rng.integers(0, classes, (b, k, 1)).astype(np.float32)
    xyxy = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    return torch.from_numpy((xyxy + cls * np.float32(stride)).astype(np.float32))


def _ragged(rng, b, k, lo=0):
    """A score-sorted valid prefix of random length per image."""
    return torch.from_numpy(np.arange(k)[None, :]
                            < rng.integers(lo, k + 1, (b, 1)))


def _sliding(k, step=3.0, side=10.0):
    """Boxes side x side sliding by `step`: each overlaps the next above 0.45
    and the one after below it, so greedy keeps every other box, and each
    kept box is decided by the one removed before it."""
    x = np.arange(k, dtype=np.float32) * np.float32(step)
    z = np.zeros(k, np.float32)
    return torch.from_numpy(np.stack([x, z, x + side, z + side], -1)[None])


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("random_K"):
        k = int(name[len("random_K"):])
        b = 3 if k <= 200 else 2 if k <= 512 else 1
        return _offset_boxes(rng, b, k), _ragged(rng, b, k, lo=k // 2)
    if name == "no_valid_box":
        boxes = _offset_boxes(rng, 3, 130)
        valid = torch.ones((3, 130), dtype=torch.bool)
        valid[1] = False
        return boxes, valid
    if name == "one_image_K512":  # the per-image CLIs' batch
        return _offset_boxes(rng, 1, 512), _ragged(rng, 1, 512, lo=256)
    if name == "one_image_no_valid":  # a frame with no candidate
        return (_offset_boxes(rng, 1, 512),
                torch.zeros((1, 512), dtype=torch.bool))
    if name == "ragged_prefix":
        return _offset_boxes(rng, 3, 200), _ragged(rng, 3, 200)
    if name == "scattered_valid":
        return (_offset_boxes(rng, 2, 150),
                torch.from_numpy(rng.random((2, 150)) < 0.7))
    if name == "class_offsets_data_stride":
        # the port's own offsets: 20 classes at a stride derived from the
        # data (huge untrained boxes make it ~3e5 / 20 a class)
        cand = np.zeros((2, 600, 6), np.float32)
        cand[..., 0:2] = rng.uniform(0, 416, (2, 600, 2))
        cand[..., 2:4] = rng.uniform(8, 160, (2, 600, 2))
        cand[:, :5, 2:4] = rng.uniform(1e4, 1.5e4, (2, 5, 2))
        cand[..., 4] = rng.uniform(0, 1, (2, 600))
        cand[..., 5] = rng.integers(0, 20, (2, 600))
        _, valid, boxes = _select_candidates(torch.from_numpy(cand), 0.25, 512)
        assert float(boxes.abs().max()) > 2.5e5
        return boxes.contiguous(), valid
    if name == "chain_within_a_word":
        boxes = _sliding(64)
        return boxes, torch.ones((1, 64), dtype=torch.bool)
    if name == "chain_across_words":
        boxes = _sliding(300)
        return boxes, torch.ones((1, 300), dtype=torch.bool)
    if name == "dense_cluster":
        # one class packed into a small area: long runs of removals
        c = rng.uniform(0, 60, (2, 512, 2))
        wh = rng.uniform(20, 60, (2, 512, 2))
        xyxy = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        return torch.from_numpy(xyxy), torch.ones((2, 512), dtype=torch.bool)
    raise KeyError(name)


CASES = ["random_K1", "random_K63", "random_K64", "random_K65",
         "random_K200", "random_K512",
         "random_K1100",  # 18 words: a word-row takes two pieces in the scan
         "no_valid_box", "one_image_K512", "one_image_no_valid",
         "ragged_prefix",
         "scattered_valid", "class_offsets_data_stride",
         "chain_within_a_word", "chain_across_words", "dense_cluster"]


@pytest.mark.parametrize("name", CASES)
def test_mocked_keep_masks_equal_reference(lib, name):
    boxes, valid = _case(name)
    want = nk.greedy_suppress_reference(boxes, valid, THR)
    got = _suppress(lib, boxes, valid)
    assert torch.equal(got, want)
    if name == "no_valid_box":
        assert not got[1].any() and got[0].any()
    if name == "one_image_no_valid":
        assert not got.any()
    if name.startswith("chain"):
        # A removes B, B would have removed C: C is kept
        assert got[0, 0::2].all() and not got[0, 1::2].any()
    if name in ("random_K512", "dense_cluster", "class_offsets_data_stride",
                "one_image_K512"):
        assert 0 < int(got.sum()) < int(valid.sum())  # something is removed


def test_mocked_iou_exactly_at_threshold_is_kept(lib):
    """A pair whose IoU in float32 is exactly the threshold: not above it,
    so both are kept; one ulp lower a threshold removes the second. The
    IoU is computed as the kernel and pairwise_iou compute it."""
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [3.0, 1.0, 13.5, 11.25]]])
    valid = torch.ones((1, 2), dtype=torch.bool)
    iou = pairwise_iou(boxes, boxes)[0, 0, 1]
    thr = float(iou)
    below = float(np.nextafter(np.float32(thr), np.float32(0.0)))
    for t, want in ((thr, [True, True]), (below, [True, False])):
        assert nk.greedy_suppress_reference(boxes, valid, t)[0].tolist() == want
        assert _suppress(lib, boxes, valid, t)[0].tolist() == want


@pytest.mark.parametrize("seed", range(4))
def test_mocked_iou_test_is_exact_at_the_threshold(lib, seed):
    """For random overlapping pairs, class offsets up to ~3e5 included, the
    threshold set to the pair's float32 IoU and to the floats either side
    of it: the kernel's IoU and compare must decide as the plain
    version's (kept, removed, kept): one rounding apart flips them."""
    rng = np.random.default_rng(seed)
    valid = torch.ones((1, 2), dtype=torch.bool)
    for _ in range(20):
        a = _offset_boxes(rng, 1, 1, extent=50.0, classes=20)
        b = a.clone()
        b[..., :2] += torch.from_numpy(rng.uniform(-20, 20, (1, 1, 2)).astype(np.float32))
        b[..., 2:] += torch.from_numpy(rng.uniform(-20, 20, (1, 1, 2)).astype(np.float32))
        boxes = torch.cat([a, b], 1)
        iou = np.float32(pairwise_iou(boxes, boxes)[0, 0, 1])
        for t, want in ((iou, True),
                        (np.nextafter(iou, np.float32(-1)), False),
                        (np.nextafter(iou, np.float32(2)), True)):
            got = _suppress(lib, boxes, valid, float(t))
            assert torch.equal(got, nk.greedy_suppress_reference(
                boxes, valid, float(t)))
            assert bool(got[0, 1]) is want


def test_mocked_mask_words_are_the_upper_triangle(lib):
    """The IoU half alone: every word at or above the diagonal holds bit u
    iff j = 64 c + u has j > i, j < K and iou > thr; then the scan half on
    it gives the reference's keep mask."""
    boxes, valid = _case("random_K200")
    b, k = valid.shape
    w = nk.mask_words(k)
    mask = torch.zeros((b, k, w), dtype=torch.int64)
    assert lib.podtpu_nms_iou_mask(boxes.data_ptr(), mask.data_ptr(), b, k,
                                   THR, None) == 0
    sup = (pairwise_iou(boxes, boxes) > THR).numpy()
    sup &= np.triu(np.ones((k, k), bool), 1)
    bits = np.zeros((b, k, w * 64), bool)
    bits[..., :k] = sup
    want = np.packbits(bits.reshape(b, k, w, 64)[..., ::-1], axis=-1)
    want = want.view(">u8")[..., 0].astype(np.uint64)
    got = mask.numpy().view(np.uint64)
    for r in range(w):
        rows = slice(64 * r, 64 * (r + 1))
        np.testing.assert_array_equal(got[:, rows, r:], want[:, rows, r:])
    keep = torch.zeros((b, k), dtype=torch.bool)
    assert lib.podtpu_nms_scan(mask.data_ptr(), valid.data_ptr(),
                               keep.data_ptr(), b, k, None) == 0
    assert torch.equal(keep, nk.greedy_suppress_reference(boxes, valid, THR))


def test_mocked_entry_points_reject_bad_arguments(lib):
    boxes = torch.zeros(8 * 4 + 1)[1:]
    assert boxes.data_ptr() % 16
    mask = torch.zeros((1, 8, 1), dtype=torch.int64)
    keep, valid = torch.zeros(8, dtype=torch.bool), torch.ones(8, dtype=torch.bool)
    args = [valid.data_ptr(), mask.data_ptr(), keep.data_ptr()]
    good = torch.zeros((1, 8, 4))
    assert lib.podtpu_nms_suppress(good.data_ptr(), *args, 1, 8, THR, None) == 0
    assert lib.podtpu_nms_suppress(boxes.data_ptr(), *args, 1, 8, THR, None) != 0
    assert lib.podtpu_nms_suppress(good.data_ptr(), *args, 1, nk.MAX_K + 1,
                                   THR, None) != 0
    assert lib.podtpu_nms_suppress(good.data_ptr(), *args, -1, 8, THR,
                                   None) != 0
    # nothing to do is no error
    assert lib.podtpu_nms_suppress(good.data_ptr(), *args, 0, 8, THR, None) == 0


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_planted_faults_fail(tmp_path, mutant):
    """Each planted fault gives another keep mask than the reference on the
    cases above (and the patch still applies to the source)."""
    old, new = MUTANTS[mutant]
    with open(SOURCE) as f:
        text = f.read()
    assert text.count(old) == 1, f"{mutant}: the patched line moved"
    path = tmp_path / f"{mutant}.cu"
    path.write_text(text.replace(old, new))
    bad = _build(str(path), str(tmp_path / f"{mutant}.so"))
    differs = []
    for name in ("random_K512", "chain_within_a_word", "dense_cluster"):
        boxes, valid = _case(name)
        differs.append(not torch.equal(
            _suppress(bad, boxes, valid),
            nk.greedy_suppress_reference(boxes, valid, THR)))
    assert all(differs), differs
