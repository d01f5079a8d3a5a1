"""What the tests of the suppression kernels' mocked build share
(``tests/test_torch_nms_mock*.py``): the g++ build against
``tools/cuda_mock``, the entry point's call and the cases."""

import ctypes
import os
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

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
    if name in ("yolov1_K49", "yolov2_K512_of_845"):
        # what the serving path hands the kernels for these heads: 7x7
        # cells of one box each (K = 49, a partial word), or 13x13x5
        # candidates cut to the top 512
        n, size = (49, 448) if name == "yolov1_K49" else (845, 416)
        cand = np.zeros((4, n, 6), np.float32)
        cand[..., 0:2] = rng.uniform(0, size, (4, n, 2))
        cand[..., 2:4] = rng.uniform(16, 240, (4, n, 2))
        cand[..., 4] = rng.uniform(0, 1, (4, n))
        cand[..., 5] = rng.integers(0, 3, (4, n))
        _, valid, boxes = _select_candidates(torch.from_numpy(cand), 0.25, 512)
        assert boxes.shape == (4, min(n, 512), 4)
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
         "yolov1_K49", "yolov2_K512_of_845",
         "chain_within_a_word", "chain_across_words", "dense_cluster"]
