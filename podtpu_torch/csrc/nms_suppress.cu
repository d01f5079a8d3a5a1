// Greedy class-aware NMS suppression for Hopper (sm_90a), as two kernels:
// a bitmask of every IoU test over the whole card, then one warp per image
// scanning it.
//
// Replaces the Pallas TPU kernel podtpu/ops/pallas/nms_kernel.py
// (pallas_greedy_suppress -> _suppress_kernel). Computes the same function:
// for score-sorted, class-offset xyxy boxes of one image, box j is removed
// when a box i < j that is still kept overlaps it with
// iou = inter / (a_i + a_j - inter + 1e-6) > thr; keep starts as `valid`.
//
// What bounds it on this card: neither bytes (an image is K = 512 boxes,
// 8 KB) nor operations (at most K^2 / 2 IoU tests) but a chain of dependent
// steps: whether box j is kept is known only once every box before it is
// resolved. The first design (one block per image, one block-wide barrier
// per kept box, each kept box's IoU row computed inside the chain) ran on 8
// of the 132 SMs at B=8, ~1,500x above its operations bound.
//
// This design takes everything that can run at once out of the chain.
// * iou_mask_kernel: every IoU test, across the card. Blocks of 256
//   threads over (image b, row block r, column block c >= r) of 64 boxes
//   each, one flat grid. The block stages its 64 column boxes and their
//   areas in shared memory; four threads share row i = 64 r + t, 16
//   columns each, and their 16-bit pieces make the word mask[b, i, c]: bit
//   u set iff j = 64 c + u has j > i, j < K and iou(i, j) > thr. A thread
//   first finds which of its pairs intersect at all and divides only for
//   those (boxes of different classes never do), so a warp pays for the
//   IEEE division as often as its busiest thread needs it, not 16 times.
//   Words below the diagonal are neither written nor read. Validity is
//   left to the scan: an invalid box is never kept, so its row is never
//   used.
// * scan_kernel: the greedy loop, one warp per image, no block barrier.
//   `removed` holds one bit a box (W = ceil(K / 64) words, shared memory)
//   and starts as ~valid. The scan walks the mask's upper triangle by
//   word-rows: for each word w the chunks (w, c), c = w .. last, of 64 rows
//   x one word (512 B), in pieces of up to 16 chunks. A piece is staged in
//   shared memory by cp.async while the one before it is used, so the walk
//   waits on L2 only at its start.
//   - Diagonal chunk (w, w): word w resolves in index order. alive =
//     ~removed[w]; take the lowest alive bit t not yet taken and clear from
//     alive the bits of row 64 w + t's diagonal word; repeat. That is the
//     only dependent chain, one step (a shared load, ffs, and-not) per box
//     taken. A ballot first finds the rows whose word meets nothing alive:
//     they are kept and change nothing, so the chain skips them.
//   - The piece's chunks (w, c > w) at once: lane l takes chunk l % 16 and
//     half its rows, ORs the words of the rows that were kept, and one
//     shuffle joins the halves: what word w removes from word c. A single
//     warp exposes the latency of every instruction it waits on, so the
//     work of a word-row runs side by side across the lanes, not one chunk
//     after another.
//   The scan stops after the word holding the last valid box.
//
// Why only j > i: IoU is symmetric bit for bit (min, max and + commute), so
// a kept i never overlaps a kept j < i above thr -- j would have removed i.
// The dense reference's clears of j < i are therefore no-ops.
//
// Bit-exactness with the plain PyTorch version: the IoU is computed in the
// operand order of ops/boxes.py::pairwise_iou, built with --fmad=false (no
// contraction of a_i + a_j - iw*ih into an FMA) and without fast math (IEEE
// division). Class offsets reach ~3e5, where a changed rounding flips
// suppressions.

#include <cuda_runtime.h>
#include <stdint.h>

// A launch, as a macro so that a host-only build of this file against a
// mock of the CUDA runtime (tools/cuda_mock) can run the kernels' logic on
// CPU threads.
#ifndef PODTPU_LAUNCH
#define PODTPU_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

// ---- PTX and warp intrinsics, one per function ------------------------------
// The mock defines PODTPU_PTX_EMULATED and emulates each of these by its
// documented semantics.
#ifndef PODTPU_PTX_EMULATED

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// 8 bytes global -> shared, asynchronously (.ca: .cg takes 16 bytes only).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Returns once at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bit l set iff lane l's predicate holds (all 32 lanes take part).
__device__ __forceinline__ unsigned int ballot(bool p) {
  return __ballot_sync(0xffffffffu, p);
}

// v of lane (this lane ^ lane_mask).
__device__ __forceinline__ unsigned int shfl_xor_bits(unsigned int v,
                                                      int lane_mask) {
  return __shfl_xor_sync(0xffffffffu, v, lane_mask);
}

#endif  // PODTPU_PTX_EMULATED

typedef unsigned long long Word;

constexpr int kBoxes = 64;            // boxes per mask word
constexpr int kWarp = 32;
constexpr int kMaxK = 8192;           // ops/kernels/nms_kernel.py MAX_K
constexpr int kMaxWords = kMaxK / kBoxes;
constexpr int kPiece = 16;            // columns a mask thread tests
constexpr int kMaskThreads = kBoxes * kBoxes / kPiece;
constexpr int kPieceChunks = 16;      // chunks the scan stages at once
constexpr int kSlot = kBoxes + 1;     // words a staged chunk takes (padded
                                      // so that lanes reading one row of 16
                                      // chunks hit different banks)
constexpr int kBatch = 8;             // words of `valid` loaded at once

__device__ __forceinline__ float area(float4 b) {
  return (b.z - b.x) * (b.w - b.y);
}

// The intersection of boxes i and j as ops/boxes.py::pairwise_iou computes
// it.
__device__ __forceinline__ float intersection(float4 bi, float4 bj) {
  const float iw = fmaxf(fminf(bi.z, bj.z) - fmaxf(bi.x, bj.x), 0.0f);
  const float ih = fmaxf(fminf(bi.w, bj.w) - fmaxf(bi.y, bj.y), 0.0f);
  return iw * ih;
}

__global__ void __launch_bounds__(kMaskThreads)
iou_mask_kernel(const float4* __restrict__ boxes, Word* __restrict__ mask,
                int k, int words, float thr) {
  __shared__ float4 sbox[kBoxes];
  __shared__ float sarea[kBoxes];
  __shared__ __align__(8) unsigned short pieces[kBoxes][kBoxes / kPiece];

  // blockIdx.x -> (image b, row block r, column block c >= r)
  const int tri = words * (words + 1) / 2;
  const int b = blockIdx.x / tri;
  int rem = blockIdx.x - b * tri;
  int r = 0;
  while (rem >= words - r) {
    rem -= words - r;
    ++r;
  }
  const int c = r + rem;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(b) * k;
  const int j0 = c * kBoxes;

  // thread (t, q): row i = 64 r + t, columns u = 16 q .. 16 q + 15; its
  // row's box loads while the block stages the columns
  const int t = tid / (kBoxes / kPiece), q = tid % (kBoxes / kPiece);
  const int i = r * kBoxes + t;
  const float4 bi = i < k ? boxes[base + i] : make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < kBoxes && j0 + tid < k) {
    const float4 bj = boxes[base + j0 + tid];
    sbox[tid] = bj;
    sarea[tid] = area(bj);
  }
  __syncthreads();

  unsigned int bits = 0;
  if (i < k) {
    const float ai = area(bi);
    const int first = c == r && t + 1 > q * kPiece ? t + 1 : q * kPiece;
    const int end = k - j0 < (q + 1) * kPiece ? k - j0 : (q + 1) * kPiece;
    // the division only where it can find iou > thr: with inter = +-0 the
    // iou is +-0 or NaN, above no thr >= 0
    const bool every = !(thr >= 0.0f);
    unsigned int meet = 0;
#pragma unroll 4
    for (int u = first; u < end; ++u)
      if (intersection(bi, sbox[u]) > 0.0f || every)
        meet |= 1u << (u - q * kPiece);
    while (meet) {
      const int u = q * kPiece + __ffs(meet) - 1;
      meet &= meet - 1;
      const float inter = intersection(bi, sbox[u]);
      const float iou = inter / (ai + sarea[u] - inter + 1e-6f);
      if (iou > thr) bits |= 1u << (u - q * kPiece);
    }
  }
  // the four pieces of a row lie in one warp: bits 16 q .. 16 q + 15
  pieces[t][q] = static_cast<unsigned short>(bits);
  __syncwarp();
  if (q == 0 && i < k)
    mask[(base + i) * words + c] = *reinterpret_cast<const Word*>(pieces[t]);
}

// A piece of the scan's walk: the chunks (w, c0) .. (w, c0 + n - 1) of the
// mask's upper triangle, n = min(16, last - c0 + 1). The walk takes for
// each word w the pieces starting at c0 = w, w + 16, ... up to `last`.
struct Piece {
  int w, c0;
  __device__ __forceinline__ int chunks(int last) const {
    return last - c0 + 1 < kPieceChunks ? last - c0 + 1 : kPieceChunks;
  }
  __device__ __forceinline__ void next(int last) {
    c0 += kPieceChunks;
    if (c0 > last) c0 = ++w;
  }
};

// Starts the copies of piece p into `stage` (chunk m's row t at
// stage[m * kSlot + t]), lane l rows l and l + 32, unless the walk is past
// its end; rows past k are left alone (their bits are never alive). One
// group either way.
__device__ __forceinline__ void stage_piece(Word* stage, const Word* rows,
                                            const Piece& p, int last, int k,
                                            int words, int lane) {
  if (p.w <= last) {
    const int n = p.chunks(last);
    for (int t = lane; t < kBoxes; t += kWarp) {
      const int i = p.w * kBoxes + t;
      if (i >= k) break;
      const Word* src = rows + static_cast<size_t>(i) * words + p.c0;
      for (int m = 0; m < n; ++m) cp_async8(stage + m * kSlot + t, src + m);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kWarp)
scan_kernel(const Word* __restrict__ mask, const uint8_t* __restrict__ valid,
            uint8_t* __restrict__ keep, int k, int words) {
  __shared__ Word removed[kMaxWords];
  __shared__ Word stages[2][kPieceChunks * kSlot];

  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const Word* rows = mask + base * words;  // row i at rows + i * words

  // removed = ~valid, two ballots a word, the loads of kBatch words in
  // flight before their ballots; `last` is the word of the last valid box,
  // the same in every lane
  int last = -1;
  for (int w0 = 0; w0 < words; w0 += kBatch) {
    bool v[2 * kBatch];
#pragma unroll
    for (int n = 0; n < 2 * kBatch; ++n) {
      const int j = w0 * kBoxes + n * kWarp + lane;
      v[n] = j < k && valid[base + j];
    }
#pragma unroll
    for (int n = 0; n < kBatch; ++n) {
      const Word bits = ballot(v[2 * n]) |
                        static_cast<Word>(ballot(v[2 * n + 1])) << kWarp;
      if (w0 + n < words) {
        if (lane == 0) removed[w0 + n] = ~bits;
        if (bits) last = w0 + n;
      }
    }
  }

  Piece ahead{0, 0};
  stage_piece(stages[0], rows, ahead, last, k, words, lane);
  ahead.next(last);
  __syncwarp();

  // lane l reduces chunk l % 16 of a piece over rows 32 (l / 16) .. + 31
  const int m = lane % kPieceChunks, h = lane / kPieceChunks;
  Word kept = 0;
  int use = 0;
  for (Piece p{0, 0}; p.w <= last; p.next(last), use ^= 1) {
    stage_piece(stages[use ^ 1], rows, ahead, last, k, words, lane);
    ahead.next(last);
    cp_async_wait_group<1>();
    __syncwarp();
    const Word* s = stages[use];
    int first = 0;
    if (p.c0 == p.w) {
      // the chain: the boxes of word w in index order, skipping the rows
      // that meet nothing alive
      const Word lo = s[lane], hi = s[lane + kWarp];
      Word alive = ~removed[p.w];
      const Word meet = ballot((lo & alive) != 0) |
                        static_cast<Word>(ballot((hi & alive) != 0)) << kWarp;
      Word left = alive & meet;
      while (left) {
        const int t = __ffsll(static_cast<long long>(left)) - 1;
        const Word d = s[t];
        alive &= ~d;
        left &= (left - 1) & ~d;
      }
      kept = alive;
      if (lane == 0) removed[p.w] = ~alive;
      first = 1;
    }
    // what the kept rows of word w remove from the piece's later words
    const bool mine = m >= first && m < p.chunks(last);
    Word acc = 0;
    if (mine) {
      const Word* col = s + m * kSlot + h * kWarp;
      const unsigned int rows_kept =
          static_cast<unsigned int>(kept >> (h * kWarp));
#pragma unroll
      for (int t = 0; t < kWarp; ++t)
        if ((rows_kept >> t) & 1) acc |= col[t];
    }
    acc |= shfl_xor_bits(static_cast<unsigned int>(acc), kPieceChunks) |
           static_cast<Word>(shfl_xor_bits(
               static_cast<unsigned int>(acc >> kWarp), kPieceChunks))
               << kWarp;
    if (mine && h == 0) removed[p.c0 + m] |= acc;
    __syncwarp();
  }

  for (int j = lane; j < k; j += kWarp)
    keep[base + j] = !((removed[j / kBoxes] >> (j % kBoxes)) & 1);
}

// 0 if (b, k) can be launched; b == 0 or k == 0 launch nothing.
int check_shape(int b, int k) {
  if (b < 0 || k < 0 || k > kMaxK) return cudaErrorInvalidValue;
  const int words = (k + kBoxes - 1) / kBoxes;
  if (k > 0 && b > 0x7fffffff / (words * (words + 1) / 2))
    return cudaErrorInvalidValue;  // the mask kernel's grid
  return cudaSuccess;
}

int launch_iou_mask(const void* boxes, void* mask, int b, int k, float thr,
                    cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(boxes) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 8)
    return cudaErrorMisalignedAddress;
  const int words = (k + kBoxes - 1) / kBoxes;
  PODTPU_LAUNCH(iou_mask_kernel, b * (words * (words + 1) / 2), kMaskThreads,
                stream, static_cast<const float4*>(boxes),
                static_cast<Word*>(mask), k, words, thr);
  return static_cast<int>(cudaGetLastError());
}

int launch_scan(const void* mask, const void* valid, void* keep, int b, int k,
                cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(mask) % 8) return cudaErrorMisalignedAddress;
  PODTPU_LAUNCH(scan_kernel, b, kWarp, stream, static_cast<const Word*>(mask),
                static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep),
                k, (k + kBoxes - 1) / kBoxes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes [b, k, 4] float32 (16-byte aligned), valid [b, k] bool (uint8),
// mask scratch [b, k, ceil(k / 64)] 8-byte words, keep [b, k] bool; k <=
// 8192. Both kernels on `stream`, one call. Returns the cudaError_t of the
// launches (0 = launched).
extern "C" int podtpu_nms_suppress(const void* boxes, const void* valid,
                                   void* mask, void* keep, int b, int k,
                                   float thr, void* stream) {
  int err = check_shape(b, k);
  if (err != cudaSuccess || b == 0 || k == 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_iou_mask(boxes, mask, b, k, thr, s);
  if (err != cudaSuccess) return err;
  return launch_scan(mask, valid, keep, b, k, s);
}

// The two halves alone, for timing each: the mask from the boxes, then the
// keep mask from the mask and valid.
extern "C" int podtpu_nms_iou_mask(const void* boxes, void* mask, int b, int k,
                                   float thr, void* stream) {
  const int err = check_shape(b, k);
  if (err != cudaSuccess || b == 0 || k == 0) return err;
  return launch_iou_mask(boxes, mask, b, k, thr,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int podtpu_nms_scan(const void* mask, const void* valid, void* keep,
                               int b, int k, void* stream) {
  const int err = check_shape(b, k);
  if (err != cudaSuccess || b == 0 || k == 0) return err;
  return launch_scan(mask, valid, keep, b, k, static_cast<cudaStream_t>(stream));
}
