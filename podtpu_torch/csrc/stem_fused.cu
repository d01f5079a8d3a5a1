// Fused Darknet stem for Hopper (sm_90a): conv3x3 (3 -> 32, stride 1, pad 1),
// train-mode BatchNorm, ReLU and the following 2x2/2 max pool, forward and
// backward, in four passes and one fixed-order reduction.
//
// Replaces the four Pallas TPU kernels of podtpu/ops/pallas/stem_fused.py
// (make_fused_stem):
//   stats    <- run_stats    (:314, body :189-207)
//   emit     <- run_emit     (:326, body :209-230)
//   bwd_sums <- run_bwd_sums (:339, body :232-272)
//   bwd_dw   <- run_bwd_dw   (:352, body :274-312)
// and computes what they compute: pre = the conv rounded to the compute
// dtype T (bf16 or f32); stats = (sum pre, sum pre^2) per channel;
// pooled = maxpool(relu(T(T(pre * mul) + add))); in the backward the pool
// routes the cotangent to the first window position holding the max,
// (0,0),(0,1),(1,0),(1,1), through the ReLU (y > 0), giving d; then
// sums = (sum d, sum d * xhat) with xhat = (pre - mean) * rinv, and
// dW[tap][co] = sum x[pixel + tap] * T(inv * (d - c0 - xhat * c1)).
//
// What bounds it on this card. The stem never materializes its
// [B, H, W, 32] conv output (708 MB in bf16 at B=64, 416 px): every pass
// recomputes the conv from the 3-channel input (66 MB), so a pass moves
// little more than its input, its [B, H/2, W/2, 32] pooled output or
// cotangent (177 MB), and nothing else: bytes bound every pass. What a
// pass spends beyond that is arithmetic per conv output: the conv's 27 x
// 32 multiply-adds (19 GFLOP a pass at B=64) and the epilogue (affine with
// two roundings, pool, routing, xhat, d_pre, the sums). On the float32
// pipes the conv alone is 9.6 G lane operations, several times the bytes
// bound's time, so in bf16 every product runs on the tensor cores and what
// is left to bound a pass is its epilogue's instructions and the fixed
// costs of a tile (two barriers, the wait for its loads).
//
// Two designs live here, one per compute dtype.
// * bf16: stats_tc_kernel, emit_tc_kernel and bwd_tc_kernel<kDw> share one
//   conv core (stage_tile, conv_unit, round_pre, affine2): the conv as
//   mma.sync m16n8k16 with f32 accumulators on fragments that ldmatrix
//   reads from a 4-channel staged tile, the next tile's rows in flight
//   (cp.async) while a tile is computed. Forward and backward produce pre
//   and y by the same instruction sequence, so the backward's pool winner
//   and ReLU mask are the forward's bit for bit, by construction. Their
//   design is the second paragraph below.
// * float32: stats_kernel, emit_kernel, bwd_sums_kernel, bwd_dw_kernel run
//   the conv on the f32 pipes (fmaf in tap order), on purpose: on the
//   tensor cores the product would be TF32. Their design is the first
//   paragraph. The templates are instantiated for float only.
// The TPU kernel's MXU formulation (block-diagonal weights, parity-split
// planar input) exists for the TPU's matrix unit and is not carried over.
//
// Design, f32-pipe kernels. A block owns a tile of 8 x 16 pooled pixels
// (16 x 32 conv pixels) at a time and walks the tiles of the whole batch
// in a fixed order (tile = blockIdx.x + k * gridDim.x; one wave of
// blocks). It stages the tile's 18 x 34 x 3 input (with the conv's halo
// and zero padding) and the 864 weights in shared memory; each of its 128
// threads takes one pooled pixel: the 4 x 4 x 3 input patch in registers,
// the four conv outputs of its 2x2 window for 8 channels at a time.
// * Reductions across blocks (stats, sums, dW) use no atomics: each thread
//   keeps its sums in registers over all its tiles, the block adds its
//   threads' sums in a fixed order into one row of a partial-sum buffer,
//   and reduce_kernel adds the rows in a fixed order. Two runs on one card
//   give the same bits.
// * dW is a product [27 x pixels] x [pixels x 32] with a long inner
//   dimension. Per tile the threads first write d_pre for 16 channels into
//   shared memory (chunks swizzled by pixel, so neighbouring threads hit
//   different banks), then each thread accumulates a 9-tap x 4-channel
//   block of dW over a tenth of the tile's pixels.
// * Rounding: the affine is two separately rounded operations (__fmul_rn,
//   __fadd_rn), as the plain x * mul + add rounds; the build's
//   --fmad=false keeps nvcc from contracting them.
//
// Design, tensor-core kernels (bf16). Same tiles, same walk, 4 warps.
// * No im2col tile is built. The input tile is staged with 4 channels a
//   pixel (the 4th zero), 8 bytes, twice: copy A, and copy B shifted by one
//   pixel. For a fixed ky the taps (kx, ci) of conv pixel c are then the 16
//   contiguous bf16 starting at staged pixel c of row r + ky, 16-byte
//   aligned in A for even c and in B for odd c, so ldmatrix reads the
//   im2col matrix straight from the staged input: K = 3 x 16 slots,
//   k = ky * 16 + kx * 4 + ci, where the slots kx = 3 and ci = 3 carry
//   zero weights (product 1) or fall into dW columns that are dropped
//   (product 2). B lies 4 sixteen-byte bank groups beyond A, so the eight
//   rows of every 8 x 8 matrix hit eight different groups.
// * Channel-major products. A warp takes units of 2 conv rows x 8 columns
//   (16 pixels = 4 pool windows):
//     pre^T[32 ch x 16 px] = W^T[32 x 48] . im2col^T[48 x 16 px]
//   then the epilogue on the accumulator fragments, where a thread holds,
//   for its 4 channels (lane / 4 + 8 i), all four positions of one pool
//   window (the register pair = dx, the two n8 tiles = dy): the pool and
//   its routing are local to a thread. The weights are A fragments in
//   registers for the whole kernel. The forward keeps this orientation
//   (whether mma.sync gives the same bits with A and B exchanged is
//   documented nowhere).
// * Loads: the raw input rows (16-byte chunks from the aligned-down row
//   start; the staging pass removes each row's phase and applies the
//   conv's zero padding) of tile k + 1 are started with cp.async into the
//   other of two stages before tile k is staged and computed; in the
//   backward the cotangent tile (8 KB, zero-filled outside the image) too.
// * stats: the epilogue rounds pre to bf16 and adds pre and pre^2 in f32
//   (the square of a bf16 value does not fit bf16), 8 sums a thread over
//   all its tiles. A unit computes its 16 conv pixels whether they lie in
//   the image or not, and the conv just beyond the border is not zero (it
//   sees the image through its halo): H and W are even, so a pool window
//   lies wholly inside or outside, and outside windows are masked to zero
//   before the sums. 17.9 KB of shared memory, no per-unit shared loads
//   beside ldmatrix, all eight units of a warp in flight.
// * The forward kernels share their walk over the tiles
//   (walk_staged_tiles), which steps from tile to tile without a division;
//   what is left of a tile's fixed cost is the instructions that start its
//   loads and stage it, and its two barriers.
// * emit: affine, then the 2 x 2 max and the ReLU on bf16 pairs (exact).
//   The store is the pass's largest byte term (177 of 243 MB), and in the
//   fragment layout a thread holds 4 channels that lie 8 apart, 2-byte
//   pieces of a 64-byte pixel. So the tile's pooled output goes through
//   an 8 KB stage in shared memory (the four 16-byte chunks of a pixel
//   XOR-swizzled by pixel: the 2-byte writes of a warp fall on 16
//   different words, the 16-byte reads of eight threads on eight bank
//   groups) and leaves with 16 bytes a thread, neighbouring threads on
//   neighbouring addresses: 1 KB contiguous per pooled tile row. A warp's
//   units fill its own two pooled rows of the stage, so it stores them
//   itself behind a barrier of the warp alone, and the store costs the
//   block no barrier. Pooled pixels outside the image are not stored.
// * bwd: channel-major products make product 1's accumulators product 2's
//   A operand, so d_pre never leaves registers:
//     dW^T[32 ch x 48] += d_pre^T[32 ch x 16 px] . im2col[16 px x 48]
//   with the 32 x 48 f32 accumulators of the warp living in registers
//   over all tiles of the block.
// * Reductions as above, free of atomics: sums go through a fixed shuffle
//   tree over the 4 lanes of a channel, then over the warps in order; the
//   warps' dW accumulators are added in warp order; reduce_kernel adds the
//   blocks' rows. mma accumulates in a fixed order, so two runs give the
//   same bits.
// * Rounding: the conv is rounded once to bf16 from the tensor core's f32
//   accumulator (the MXU route of stem_fused.py:148-157). Its summation
//   order differs from cuDNN's and from fmaf in tap order, so against the
//   plain version a pre-activation may land on the neighbouring bf16 value
//   now and then. The affine runs on bf16 pairs (mul.bf16x2, add.bf16x2:
//   one rounding of an exact result each, which is what f32 arithmetic
//   rounded to bf16 gives).

#include <cuda_bf16.h>
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

// ---- PTX, one instruction per function -------------------------------------
// The mock defines PODTPU_PTX_EMULATED and emulates each of these by its
// documented fragment layout (lane -> row / column), so the indexing around
// them can be rehearsed without a card.
#ifndef PODTPU_PTX_EMULATED

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the bytes beyond `bytes` (0..16)
// are written as zeros and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 matrices of 16-bit values. Lane l gives the address of the
// 16-byte row l % 8 of matrix l / 8; r[m] receives, of matrix m, the
// elements (row lane / 4, columns 2 * (lane % 4) and + 1).
__device__ __forceinline__ void ldmatrix_x4(const void* row,
                                            unsigned int (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The same, transposed: r[m] receives the elements (rows 2 * (lane % 4) and
// + 1, column lane / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(const void* row,
                                                  unsigned int (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, f32 accumulators.
// With g = lane / 4, t = lane % 4: a[0..3] = (row g | g + 8 | g | g + 8,
// columns 2t, 2t + 1 | same | + 8 | + 8); b0, b1 = (rows 2t, 2t + 1 | + 8,
// column g); c[0..3] = (row g | g | g + 8 | g + 8, column 2t | 2t + 1 | ..).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned int (&a)[4],
                                         unsigned int b0, unsigned int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float shfl_xor(float v, int lane_mask) {
  return __shfl_xor_sync(0xffffffffu, v, lane_mask);
}

#endif  // PODTPU_PTX_EMULATED

constexpr int kCi = 3;
constexpr int kCo = 32;
constexpr int kTaps = 9 * kCi;             // 27, ordered (ky, kx, ci)
constexpr int kTPY = 8;                    // pooled rows per tile
constexpr int kTPX = 16;                   // pooled columns per tile
constexpr int kThreads = kTPY * kTPX;      // 128: one pooled pixel each
constexpr int kCY = 2 * kTPY;              // conv rows per tile
constexpr int kCX = 2 * kTPX;              // conv columns per tile
constexpr int kConvPx = kCY * kCX;         // 512
constexpr int kIY = kCY + 2;               // input tile rows (halo 1)
constexpr int kIX = kCX + 2;               // input tile columns
constexpr int kTileIn = kIY * kIX * kCi;   // 1836
constexpr int kGroup = 8;                  // channels per register group
constexpr int kGroups = kCo / kGroup;      // 4
constexpr int kHalf = kCo / 2;             // dW: channels per shared pass
constexpr int kDwTiles = kCi * (kHalf / 4);  // 12 blocks of 9 taps x 4 ch
constexpr int kDwSlices = kThreads / kDwTiles;  // 10 pixel slices

// rows of the per-channel vector argument [kVecRows][kCo]
enum { kMul, kAdd, kMean, kRinv, kInv, kC0, kC1, kVecRows };

// h: the rows the conv is computed for. With a halo (a block of an
// image's rows under the spatial layout) the input holds hin = h + 2 rows:
// one row of the block above, the h interior rows, one row of the block
// below. Conv row y reads input rows y - 1 + halo .. y + 1 + halo, and only
// rows outside [0, hin) are the conv's zero padding.
struct Shape {
  int b, h, w, ph, pw, tiles_y, tiles_x, tiles, halo, hin;
};

Shape make_shape(int b, int h, int w, int halo) {
  Shape s;
  s.b = b;
  s.h = h;
  s.halo = halo;
  s.hin = h + 2 * halo;
  s.w = w;
  s.ph = h / 2;
  s.pw = w / 2;
  s.tiles_y = (s.ph + kTPY - 1) / kTPY;
  s.tiles_x = (s.pw + kTPX - 1) / kTPX;
  s.tiles = b * s.tiles_y * s.tiles_x;
  return s;
}

struct Tile {
  int img, py0, px0;
};

__device__ __forceinline__ Tile tile_at(const Shape& s, int t) {
  Tile r;
  const int per_img = s.tiles_y * s.tiles_x;
  r.img = t / per_img;
  const int rem = t - r.img * per_img;
  r.py0 = (rem / s.tiles_x) * kTPY;
  r.px0 = (rem % s.tiles_x) * kTPX;
  return r;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
// Round an f32 value to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
// 8 consecutive f32 values (32-byte aligned).
__device__ __forceinline__ void load8(const float* src, float (&v)[kGroup]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[kGroup]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             float* ws) {
  for (int i = threadIdx.x; i < kTaps * kCo; i += kThreads) ws[i] = w[i];
}

__device__ __forceinline__ void load_vec(const float* __restrict__ vec,
                                         int rows, float* vs) {
  for (int i = threadIdx.x; i < rows * kCo; i += kThreads) vs[i] = vec[i];
}

// xs[(r * kIX + c) * kCi + ci] = x[img, 2*py0 - 1 + r, 2*px0 - 1 + c, ci]
// (input row shifted by the halo), zero outside the input (the conv's
// padding).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x,
                                          const Shape& s, const Tile& t,
                                          float* xs) {
  const int y0 = 2 * t.py0 - 1;
  const int x0 = 2 * t.px0 - 1;
  const T* img = x + static_cast<size_t>(t.img) * s.hin * s.w * kCi;
  for (int i = threadIdx.x; i < kTileIn; i += kThreads) {
    const int ci = i % kCi;
    const int rc = i / kCi;
    const int c = rc % kIX;
    const int r = rc / kIX;
    const int yy = y0 + r + s.halo;
    const int xx = x0 + c;
    float v = 0.0f;
    if (yy >= 0 && yy < s.hin && xx >= 0 && xx < s.w)
      v = to_f32(img[(static_cast<size_t>(yy) * s.w + xx) * kCi + ci]);
    xs[i] = v;
  }
}

// The 4 x 4 x 3 input patch of the pooled pixel (ly, lx) of the tile.
__device__ __forceinline__ void load_patch(const float* xs, int ly, int lx,
                                           float (&p)[4][4][kCi]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int ci = 0; ci < kCi; ++ci)
        p[r][c][ci] = xs[((2 * ly + r) * kIX + 2 * lx + c) * kCi + ci];
}

// pre[q][c]: the conv at window position q = 2*dy + dx for channel
// g*kGroup + c, accumulated in f32 in tap order and rounded to T.
template <typename T>
__device__ __forceinline__ void conv_group(const float (&p)[4][4][kCi],
                                           const float* ws, int g,
                                           float (&pre)[4][kGroup]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < kGroup; ++c) pre[q][c] = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int ci = 0; ci < kCi; ++ci) {
        const int tap = (ky * 3 + kx) * kCi + ci;
        float wv[kGroup];
        load8(ws + tap * kCo + g * kGroup, wv);
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float xv = p[dy + ky][dx + kx][ci];
#pragma unroll
            for (int c = 0; c < kGroup; ++c)
              pre[dy * 2 + dx][c] = fmaf(xv, wv[c], pre[dy * 2 + dx][c]);
          }
      }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < kGroup; ++c) pre[q][c] = round_to<T>(pre[q][c]);
}

// y = T(T(pre * mul) + add): the BN affine as two rounded operations.
template <typename T>
__device__ __forceinline__ float bn_apply(float pre, float mul, float add) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(pre, mul)), add));
}

// dL/dy at the four window positions: the pooled cotangent goes to the
// first position holding the max of relu(y), and only where y > 0.
__device__ __forceinline__ void route(const float (&y)[4], float gv,
                                      float (&d)[4]) {
  const float z0 = fmaxf(y[0], 0.0f), z1 = fmaxf(y[1], 0.0f);
  const float z2 = fmaxf(y[2], 0.0f), z3 = fmaxf(y[3], 0.0f);
  const float m = fmaxf(fmaxf(z0, z1), fmaxf(z2, z3));
  const bool w0 = z0 == m;
  const bool w1 = !w0 && z1 == m;
  const bool w2 = !w0 && !w1 && z2 == m;
  const bool w3 = !w0 && !w1 && !w2 && z3 == m;
  d[0] = (w0 && y[0] > 0.0f) ? gv : 0.0f;
  d[1] = (w1 && y[1] > 0.0f) ? gv : 0.0f;
  d[2] = (w2 && y[2] > 0.0f) ? gv : 0.0f;
  d[3] = (w3 && y[3] > 0.0f) ? gv : 0.0f;
}

// out[k] = sum of v[k] over the block's threads, in thread order. red
// holds kThreads * 17 floats. Every thread calls it.
template <int kCols>
__device__ __forceinline__ void block_sum(const float (&v)[kCols], float* red,
                                          float* __restrict__ out) {
  constexpr int kChunk = 16;
  static_assert(kCols % kChunk == 0, "columns come in chunks of 16");
#pragma unroll
  for (int k0 = 0; k0 < kCols; k0 += kChunk) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      red[threadIdx.x * (kChunk + 1) + j] = v[k0 + j];
    __syncthreads();
    if (threadIdx.x < kChunk) {
      float acc = 0.0f;
      for (int t = 0; t < kThreads; ++t)
        acc += red[t * (kChunk + 1) + threadIdx.x];
      out[k0 + threadIdx.x] = acc;
    }
    __syncthreads();
  }
}

// ---- forward -------------------------------------------------------------

// partials[blockIdx.x] = (sum pre [32], sum pre^2 [32]) over its tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, const float* __restrict__ w, Shape s,
             float* __restrict__ partials) {
  __shared__ __align__(16) float ws[kTaps * kCo];
  __shared__ float xs[kTileIn];
  __shared__ float red[kThreads * 17];
  load_weights(w, ws);
  const int ly = threadIdx.x / kTPX;
  const int lx = threadIdx.x % kTPX;
  float acc[2 * kCo];
#pragma unroll
  for (int k = 0; k < 2 * kCo; ++k) acc[k] = 0.0f;

  for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const Tile tl = tile_at(s, t);
    __syncthreads();  // the previous tile's patch reads are done
    load_tile(x, s, tl, xs);
    __syncthreads();
    if (tl.py0 + ly >= s.ph || tl.px0 + lx >= s.pw) continue;
    float p[4][4][kCi];
    load_patch(xs, ly, lx, p);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float pre[4][kGroup];
      conv_group<T>(p, ws, g, pre);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          acc[g * kGroup + c] += pre[q][c];
          acc[kCo + g * kGroup + c] =
              fmaf(pre[q][c], pre[q][c], acc[kCo + g * kGroup + c]);
        }
    }
  }
  block_sum(acc, red, partials + static_cast<size_t>(blockIdx.x) * 2 * kCo);
}

// out[b, py, px, c] = max over the window of relu(T(T(pre * mul) + add)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ vec, Shape s, T* __restrict__ out) {
  __shared__ __align__(16) float ws[kTaps * kCo];
  __shared__ float xs[kTileIn];
  __shared__ float vs[2 * kCo];
  load_weights(w, ws);
  load_vec(vec, 2, vs);
  const int ly = threadIdx.x / kTPX;
  const int lx = threadIdx.x % kTPX;

  for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const Tile tl = tile_at(s, t);
    __syncthreads();
    load_tile(x, s, tl, xs);
    __syncthreads();
    const int py = tl.py0 + ly, px = tl.px0 + lx;
    if (py >= s.ph || px >= s.pw) continue;
    float p[4][4][kCi];
    load_patch(xs, ly, lx, p);
    T* dst = out + ((static_cast<size_t>(tl.img) * s.ph + py) * s.pw + px) * kCo;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float pre[4][kGroup];
      conv_group<T>(p, ws, g, pre);
      float v[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        const float mul = vs[kMul * kCo + g * kGroup + c];
        const float add = vs[kAdd * kCo + g * kGroup + c];
        float m = 0.0f;  // max(relu(y_q)) == max(0, y_0..y_3)
#pragma unroll
        for (int q = 0; q < 4; ++q) m = fmaxf(m, bn_apply<T>(pre[q][c], mul, add));
        v[c] = m;
      }
      store8(dst + g * kGroup, v);
    }
  }
}

// ---- backward ------------------------------------------------------------

// partials[blockIdx.x] = (sum d [32], sum d * xhat [32]) over its tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_sums_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ vec, const T* __restrict__ gout,
                Shape s, float* __restrict__ partials) {
  __shared__ __align__(16) float ws[kTaps * kCo];
  __shared__ float xs[kTileIn];
  __shared__ float vs[kVecRows * kCo];
  __shared__ float red[kThreads * 17];
  load_weights(w, ws);
  load_vec(vec, kVecRows, vs);
  const int ly = threadIdx.x / kTPX;
  const int lx = threadIdx.x % kTPX;
  float acc[2 * kCo];
#pragma unroll
  for (int k = 0; k < 2 * kCo; ++k) acc[k] = 0.0f;

  for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const Tile tl = tile_at(s, t);
    __syncthreads();
    load_tile(x, s, tl, xs);
    __syncthreads();
    const int py = tl.py0 + ly, px = tl.px0 + lx;
    if (py >= s.ph || px >= s.pw) continue;
    float p[4][4][kCi];
    load_patch(xs, ly, lx, p);
    const T* gsrc =
        gout + ((static_cast<size_t>(tl.img) * s.ph + py) * s.pw + px) * kCo;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float pre[4][kGroup];
      conv_group<T>(p, ws, g, pre);
      float gv[kGroup];
      load8(gsrc + g * kGroup, gv);
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        const int k = g * kGroup + c;
        float y[4], d[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          y[q] = bn_apply<T>(pre[q][c], vs[kMul * kCo + k], vs[kAdd * kCo + k]);
        route(y, gv[c], d);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float xh = __fmul_rn(__fsub_rn(pre[q][c], vs[kMean * kCo + k]),
                                     vs[kRinv * kCo + k]);
          acc[k] += d[q];
          acc[kCo + k] = fmaf(d[q], xh, acc[kCo + k]);
        }
      }
    }
  }
  block_sum(acc, red, partials + static_cast<size_t>(blockIdx.x) * 2 * kCo);
}

// Position of channel chunk `chunk` (4 channels) of conv pixel q in the
// d_pre tile: chunks are XOR-swizzled by pixel so that the 16 threads of a
// tile row, whose pixels lie 2 apart, write to different banks.
__device__ __forceinline__ int dp_index(int q, int chunk) {
  return q * kHalf + ((chunk ^ ((q >> 1) & 3)) << 2);
}

// partials[blockIdx.x][tap * 32 + co] = sum over its tiles of
// x[pixel + tap] * T(inv * (d - c0 - xhat * c1)), taps (ky, kx, ci).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ vec, const T* __restrict__ gout,
              Shape s, float* __restrict__ partials) {
  __shared__ __align__(16) float ws[kTaps * kCo];
  __shared__ float xs[kTileIn];
  __shared__ float vs[kVecRows * kCo];
  __shared__ __align__(16) float dp[kConvPx * kHalf];  // 32 KB
  load_weights(w, ws);
  load_vec(vec, kVecRows, vs);
  const int ly = threadIdx.x / kTPX;
  const int lx = threadIdx.x % kTPX;
  // the dW block this thread accumulates: input channel ci, channels
  // half * 16 + cg * 4 .. + 3, over the tile pixels q = slice (mod 10)
  const int bt = threadIdx.x % kDwTiles;
  const int slice = threadIdx.x / kDwTiles;
  const int ci = bt / (kHalf / 4);
  const int cg = bt % (kHalf / 4);
  const bool accumulates = slice < kDwSlices;
  float acc[2][9][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int tp = 0; tp < 9; ++tp)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[h][tp][k] = 0.0f;

  for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const Tile tl = tile_at(s, t);
    __syncthreads();
    load_tile(x, s, tl, xs);
    __syncthreads();
    const int py = tl.py0 + ly, px = tl.px0 + lx;
    const bool inside = py < s.ph && px < s.pw;
    float p[4][4][kCi];
    load_patch(xs, ly, lx, p);
    const T* gsrc =
        gout + ((static_cast<size_t>(tl.img) * s.ph + py) * s.pw + px) * kCo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // phase A: d_pre of this thread's four conv pixels, 16 channels
#pragma unroll
      for (int gh = 0; gh < 2; ++gh) {
        const int g = 2 * h + gh;
        float dq[4][kGroup];
        if (inside) {
          float pre[4][kGroup];
          conv_group<T>(p, ws, g, pre);
          float gv[kGroup];
          load8(gsrc + g * kGroup, gv);
#pragma unroll
          for (int c = 0; c < kGroup; ++c) {
            const int k = g * kGroup + c;
            float y[4], d[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              y[q] = bn_apply<T>(pre[q][c], vs[kMul * kCo + k],
                                 vs[kAdd * kCo + k]);
            route(y, gv[c], d);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float xh = __fmul_rn(
                  __fsub_rn(pre[q][c], vs[kMean * kCo + k]), vs[kRinv * kCo + k]);
              const float inner = __fsub_rn(
                  __fsub_rn(d[q], vs[kC0 * kCo + k]),
                  __fmul_rn(xh, vs[kC1 * kCo + k]));
              dq[q][c] = round_to<T>(__fmul_rn(vs[kInv * kCo + k], inner));
            }
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < kGroup; ++c) dq[q][c] = 0.0f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cq = (2 * ly + q / 2) * kCX + 2 * lx + q % 2;
          float* row = dp + dp_index(cq, 2 * gh);
          reinterpret_cast<float4*>(row)[0] =
              make_float4(dq[q][0], dq[q][1], dq[q][2], dq[q][3]);
          row = dp + dp_index(cq, 2 * gh + 1);
          reinterpret_cast<float4*>(row)[0] =
              make_float4(dq[q][4], dq[q][5], dq[q][6], dq[q][7]);
        }
      }
      __syncthreads();
      // phase B: dW block += x patch (9 taps of channel ci) x d_pre chunk
      if (accumulates) {
        for (int q = slice; q < kConvPx; q += kDwSlices) {
          const int qy = q / kCX, qx = q % kCX;
          const float4 dv =
              *reinterpret_cast<const float4*>(dp + dp_index(q, cg));
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const float xv = xs[((qy + ky) * kIX + qx + kx) * kCi + ci];
              float* a = acc[h][ky * 3 + kx];
              a[0] = fmaf(xv, dv.x, a[0]);
              a[1] = fmaf(xv, dv.y, a[1]);
              a[2] = fmaf(xv, dv.z, a[2]);
              a[3] = fmaf(xv, dv.w, a[3]);
            }
        }
      }
      __syncthreads();  // phase B is done with dp before it is rewritten
    }
  }

  // add the slices in order: red[(slice * kDwTiles + bt) * 36 + tap * 4 + k]
  float* red = dp;
  float* out = partials + static_cast<size_t>(blockIdx.x) * kTaps * kCo;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (accumulates)
#pragma unroll
      for (int tp = 0; tp < 9; ++tp)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          red[(slice * kDwTiles + bt) * 36 + tp * 4 + k] = acc[h][tp][k];
    __syncthreads();
    for (int o = threadIdx.x; o < kDwTiles * 36; o += kThreads) {
      float sum = 0.0f;
      for (int sl = 0; sl < kDwSlices; ++sl) sum += red[(sl * kDwTiles) * 36 + o];
      const int obt = o / 36, tp = (o % 36) / 4, k = o % 4;
      const int oci = obt / (kHalf / 4), ocg = obt % (kHalf / 4);
      out[(tp * kCi + oci) * kCo + h * kHalf + ocg * 4 + k] = sum;
    }
    __syncthreads();
  }
}

// ---- bf16: every product on the tensor cores -------------------------------

constexpr int kWarps = kThreads / 32;          // 4
constexpr int kSlots = 48;                     // K: ky * 16 + kx * 4 + ci
constexpr int kStagePx = kIY * kIX;            // 612 staged pixels
// a copy of the staged tile: 4 bf16 a pixel, and 4 pixels of zeros after
// the last row, which the slots kx = 3 of its last pixels read. 616 * 8 B =
// 308 sixteen-byte groups, 4 mod 8: copy B starts 4 bank groups after A.
constexpr int kCopyPx = kStagePx + 4;
constexpr int kRawChunks = 14;                 // 14 + 34 * 6 bytes <= 14 * 16
constexpr int kRawRow = kRawChunks * 16;       // bytes of a raw input row
constexpr int kRawBytes = kIY * kRawRow;       // 4032 a stage
// a pooled tile, 64 bytes a pixel: a cotangent stage, or emit's output stage
constexpr int kGBytes = kThreads * kCo * 2;    // 8192
// the input side of a kernel's shared memory: copies A and B, then two
// stages of raw rows
constexpr int kXSmem = 2 * kCopyPx * 8 + 2 * kRawBytes;  // 17,920
constexpr int kTcSmem = kXSmem + 2 * kGBytes + kCo * 32;  // + constants
static_assert(kCopyPx * 8 % 128 == 64, "copy B must lie 4 bank groups off A");
static_assert(kXSmem % 128 == 0, "what follows the input side stays aligned");
static_assert(kWarps * kCo * kSlots * 4 <= kTcSmem - kCo * 32,
              "the warps' dW tiles are added through the staging buffers");

// What the backward's epilogue reads per channel, laid out for two 16-byte
// loads: the four lanes of a channel read one address (a broadcast), the
// eight channels of a warp-wide load 128 contiguous bytes.
struct __align__(16) ChannelConsts {
  float mean, rinv, inv, c1;
  float c0;
  __nv_bfloat162 mul2, add2;  // mul and add (bf16 values) as pairs
  float unused;
};
static_assert(sizeof(ChannelConsts) == 32, "two float4 a channel");

__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  return static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ unsigned int bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned int*>(&v);
}

// The weight of slot k of row ky for channel ch: zero for kx = 3, ci = 3.
__device__ __forceinline__ float slot_weight(const float* __restrict__ w,
                                             int ky, int k, int ch) {
  const int kx = k >> 2, ci = k & 3;
  return (kx < 3 && ci < kCi) ? w[((ky * 3 + kx) * kCi + ci) * kCo + ch]
                              : 0.0f;
}

// W^T as A fragments: wf[m][ky] is the 16 x 16 block of channels
// 16 m .. 16 m + 15 and the slots of row ky (gid = lane / 4, tig = lane % 4).
__device__ __forceinline__ void load_weight_frags(
    const float* __restrict__ w, int gid, int tig,
    unsigned int (&wf)[2][3][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ch = m * 16 + gid + (r & 1) * 8;
        const int k = 2 * tig + (r >> 1) * 8;
        wf[m][ky][r] = pack_bf16x2(slot_weight(w, ky, k, ch),
                                   slot_weight(w, ky, k + 1, ch));
      }
}

// First byte of the raw row y (conv coordinates) of the tile's input
// window in x: image columns from ca on.
__device__ __forceinline__ const unsigned char* raw_row_start(
    const __nv_bfloat16* __restrict__ x, const Shape& s, int img, int y,
    int ca) {
  return reinterpret_cast<const unsigned char*>(
      x + ((static_cast<size_t>(img) * s.hin + y + s.halo) * s.w + ca) * kCi);
}

// Whether conv row y reads a row of the input (its halo rows included),
// not the zero padding.
__device__ __forceinline__ bool row_in_input(const Shape& s, int y) {
  return y + s.halo >= 0 && y + s.halo < s.hin;
}

// Loads and staging share one map of threads onto the 18 x 34 input
// window: thread i takes segment i % 7 of row i / 7 (126 threads), that is
// two of the row's 14 chunks and five of its 34 (35) pixels.
constexpr int kSegs = 7;
static_assert(kSegs * 2 == kRawChunks && kSegs * 5 >= kIX &&
                  kSegs * kIY <= kThreads,
              "7 segments cover a row, 126 threads the window");

// Start the loads of tile t's input into a stage: the raw input rows as
// 16-byte chunks from each row's aligned-down start up to its last needed
// byte (rows outside the image are skipped; the staging pass does not read
// them).
__device__ __forceinline__ void start_x_loads(
    const __nv_bfloat16* __restrict__ x, const Shape& s, const Tile& t,
    unsigned char* raw) {
  const int x0 = 2 * t.px0 - 1;
  const int ca = x0 < 0 ? 0 : x0;
  const int cb = x0 + kIX < s.w ? x0 + kIX : s.w;
  const int r = threadIdx.x / kSegs, sg = threadIdx.x % kSegs;
  const int y = 2 * t.py0 - 1 + r;
  if (r < kIY && row_in_input(s, y)) {
    const unsigned char* first = raw_row_start(x, s, t.img, y, ca);
    const unsigned char* end = first + (cb - ca) * kCi * 2;
    const unsigned char* src =
        first - (reinterpret_cast<uintptr_t>(first) & 15) + sg * 32;
    unsigned char* dst = raw + r * kRawRow + sg * 32;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const long long left = end - (src + c * 16);
      if (left > 0)
        cp_async16(dst + c * 16, src + c * 16,
                   left < 16 ? static_cast<int>(left) : 16);
    }
  }
}

// Start the loads of tile t's cotangent into a stage: 64 bytes a pooled
// pixel (one a thread), zeros outside the image.
__device__ __forceinline__ void start_g_loads(
    const __nv_bfloat16* __restrict__ gout, const Shape& s, const Tile& t,
    unsigned char* gs) {
  const int py = t.py0 + threadIdx.x / kTPX, px = t.px0 + threadIdx.x % kTPX;
  const bool in = py < s.ph && px < s.pw;
  const __nv_bfloat16* src =
      in ? gout + ((static_cast<size_t>(t.img) * s.ph + py) * s.pw + px) * kCo
         : gout;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    cp_async16(gs + threadIdx.x * 64 + c * 16, src + (in ? c * 8 : 0),
               in ? 16 : 0);
}

// The 4 pixels of zeros behind each copy are written here once; stage_tile
// writes every other staged pixel of every tile.
__device__ __forceinline__ void clear_copies(uint2* xa) {
  for (int i = threadIdx.x; i < 2 * kCopyPx; i += kThreads)
    xa[i] = make_uint2(0u, 0u);
}

// Raw rows -> the two 4-channel copies: xa[p] = staged pixel p (row p / 34,
// column p % 34 of the input window, zero outside the image), xb[p] =
// staged pixel p + 1.
__device__ __forceinline__ void stage_tile(
    const __nv_bfloat16* __restrict__ x, const Shape& s, const Tile& t,
    const unsigned char* raw, uint2* xa, uint2* xb) {
  const int r = threadIdx.x / kSegs, sg = threadIdx.x % kSegs;
  if (r >= kIY) return;
  const int x0 = 2 * t.px0 - 1;
  const int ca = x0 < 0 ? 0 : x0;
  const int y = 2 * t.py0 - 1 + r;
  const bool row_in = row_in_input(s, y);
  // the row's bytes begin at its phase within the first chunk
  const int phase =
      row_in ? static_cast<int>(reinterpret_cast<uintptr_t>(
                                    raw_row_start(x, s, t.img, y, ca)) & 15)
             : 0;
  const unsigned short* src =
      reinterpret_cast<const unsigned short*>(raw + r * kRawRow + phase);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int c = sg * 5 + i;
    if (c >= kIX) break;
    const int xc = x0 + c;
    uint2 v = make_uint2(0u, 0u);
    if (row_in && xc >= 0 && xc < s.w) {
      const unsigned short* q = src + (xc - ca) * kCi;
      v.x = static_cast<unsigned int>(q[0]) |
            (static_cast<unsigned int>(q[1]) << 16);
      v.y = q[2];
    }
    const int p = r * kIX + c;
    xa[p] = v;
    if (p > 0) xb[p - 1] = v;
  }
}

// ldmatrix: a lane addresses row lane % 8 of matrix lane / 8; matrix
// (rr, h) of a load holds slots 8 h .. 8 h + 7 of the 8 conv pixels of
// one staged row: staged pixels c0 + 2 h + (0..7), even ones in copy A,
// odd ones in copy B (xb[p - 1] = pixel p). This is the lane's address for
// the unit at staged pixel 0; a unit adds its own offset.
__device__ __forceinline__ const uint2* ldmatrix_lane_row(const uint2* xa,
                                                          const uint2* xb,
                                                          int lane) {
  const int li = lane & 7, lh = (lane >> 3) & 1, lr = lane >> 4;
  return ((li & 1) ? xb - 1 : xa) + lr * kIX + li + 2 * lh;
}

// Product 1 of a unit of 2 conv rows x 8 conv columns whose lane address
// is `rows`: acc[m][dy] = the conv, in f32, of channels 16 m + gid (+ 8)
// at conv row dy, columns 2 tig and 2 tig + 1. Every kernel's conv is this
// function, so they all sum it in one order.
__device__ __forceinline__ void conv_unit(const uint2* rows,
                                          const unsigned int (&wf)[2][3][4],
                                          float (&acc)[2][2][4]) {
  // nb[rr][h] = slots 8 h.. of staged row rr of the unit
  unsigned int nb[4][2];
  {
    unsigned int r4[4];
    ldmatrix_x4(rows, r4);
    nb[0][0] = r4[0]; nb[0][1] = r4[1]; nb[1][0] = r4[2]; nb[1][1] = r4[3];
    ldmatrix_x4(rows + 2 * kIX, r4);
    nb[2][0] = r4[0]; nb[2][1] = r4[1]; nb[3][0] = r4[2]; nb[3][1] = r4[3];
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][dy][r] = 0.0f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
        mma_bf16(acc[m][dy], wf[m][ky], nb[dy + ky][0], nb[dy + ky][1]);
    }
}

// pre of one channel at one conv row, columns dx = 0, 1: an accumulator
// pair rounded once to bf16 (hf picks the channel gid + 8 hf of the block).
__device__ __forceinline__ __nv_bfloat162 round_pre(const float (&a)[4],
                                                    int hf) {
  return __floats2bfloat162_rn(a[2 * hf], a[2 * hf + 1]);
}

// bn_apply() on pairs. Each packed operation rounds its exact result once;
// f32 arithmetic rounded to bf16 gives the same value: the product of two
// bf16 values is exact in f32, and so is their sum unless one is below
// 2^-16 of the other, too small to move either rounding.
__device__ __forceinline__ __nv_bfloat162 affine2(__nv_bfloat162 pre2,
                                                  __nv_bfloat162 mul2,
                                                  __nv_bfloat162 add2) {
  return __hadd2_rn(__hmul2_rn(pre2, mul2), add2);
}

// row = (sum over the block of a [32], of b [32]), where a thread's a[i]
// and b[i] belong to channel gid + 8 i: the 4 lanes of a channel in a
// fixed tree, then the warps in order. red holds kWarps * 64 floats that
// no thread still reads. Every thread calls it.
__device__ __forceinline__ void block_channel_sums(float (&a)[4], float (&b)[4],
                                                   float* red,
                                                   float* __restrict__ row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] += shfl_xor(a[i], 1);
    a[i] += shfl_xor(a[i], 2);
    b[i] += shfl_xor(b[i], 1);
    b[i] += shfl_xor(b[i], 2);
    if (tig == 0) {
      red[warp * 2 * kCo + gid + 8 * i] = a[i];
      red[warp * 2 * kCo + kCo + gid + 8 * i] = b[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kCo) {
    float sum = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp)
      sum += red[wp * 2 * kCo + threadIdx.x];
    row[threadIdx.x] = sum;
  }
}

// ---- forward, bf16 ----------------------------------------------------------

// tile_at(s, t + step) from tile_at(s, t) without a division: step is the
// grid's size as (images, tile rows, tile columns), and the carries go up.
struct TileStep {
  int img, py, px;
};

__device__ __forceinline__ TileStep tile_step(const Shape& s, int step) {
  const Tile d = tile_at(s, step);
  return {d.img, d.py0, d.px0};
}

__device__ __forceinline__ Tile next_tile(const Shape& s, Tile t,
                                          const TileStep& d) {
  t.px0 += d.px;
  t.py0 += d.py;
  t.img += d.img;
  if (t.px0 >= s.tiles_x * kTPX) {
    t.px0 -= s.tiles_x * kTPX;
    t.py0 += kTPY;
  }
  if (t.py0 >= s.tiles_y * kTPY) {
    t.py0 -= s.tiles_y * kTPY;
    t.img += 1;
  }
  return t;
}

// Walks the block's tiles (tile = blockIdx.x + k * gridDim.x) as
// bwd_tc_kernel does, the next tile's raw rows in flight while a tile is
// staged and computed, and calls compute(tile) on each staged tile. sm
// holds kXSmem bytes: copies A and B, then the two raw stages. Every thread
// calls it.
template <typename F>
__device__ __forceinline__ void walk_staged_tiles(
    const __nv_bfloat16* __restrict__ x, const Shape& s, unsigned char* sm,
    F&& compute) {
  uint2* xa = reinterpret_cast<uint2*>(sm);
  uint2* xb = xa + kCopyPx;
  unsigned char* raw = sm + 2 * kCopyPx * 8;
  clear_copies(xa);

  // the grid has at most one block a tile: every block has a first tile
  Tile tl = tile_at(s, blockIdx.x);
  const TileStep step = tile_step(s, gridDim.x);
  start_x_loads(x, s, tl, raw);
  cp_async_commit();

  int stage = 0;
  for (int t = blockIdx.x; t < s.tiles; t += gridDim.x, stage ^= 1) {
    cp_async_wait_all();  // this thread's loads of tile t have landed
    __syncthreads();      // everyone's have; the previous tile is computed
    Tile nx = tl;
    if (t + gridDim.x < s.tiles) {
      nx = next_tile(s, tl, step);
      start_x_loads(x, s, nx, raw + (stage ^ 1) * kRawBytes);
    }
    cp_async_commit();
    stage_tile(x, s, tl, raw + stage * kRawBytes, xa, xb);
    __syncthreads();
    compute(tl);
    tl = nx;
  }
  cp_async_wait_all();
}

// partials[blockIdx.x] = (sum pre [32], sum pre^2 [32]) over its tiles.
__global__ void __launch_bounds__(kThreads)
stats_tc_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ w, Shape s,
                float* __restrict__ partials) {
  __shared__ __align__(128) unsigned char sm[kXSmem];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  unsigned int wf[2][3][4];
  load_weight_frags(w, gid, tig, wf);
  const uint2* lane_row = ldmatrix_lane_row(
      reinterpret_cast<const uint2*>(sm),
      reinterpret_cast<const uint2*>(sm) + kCopyPx, lane);
  float sum[4], sq[4];  // this thread's 4 channels
#pragma unroll
  for (int i = 0; i < 4; ++i) sum[i] = sq[i] = 0.0f;

  walk_staged_tiles(x, s, sm, [&](const Tile& tl) {
    // units as in bwd_tc_kernel: this thread's pool window is
    // (j, 4 cg + tig), and it holds all four of its conv outputs. All
    // eight units of a warp are in flight (112 registers, 4 blocks an SM:
    // measured faster than four in flight at 72 registers and 7 blocks)
#pragma unroll 8
    for (int u = 0; u < 8; ++u) {
      const int j = 2 * warp + (u >> 2), cg = u & 3;
      // the conv of a window outside the image (ragged tiles) is not zero:
      // it is masked out of the sums, bit by bit, without a branch
      const unsigned int keep =
          (tl.py0 + j < s.ph && tl.px0 + 4 * cg + tig < s.pw) ? 0xffffffffu
                                                              : 0u;
      float acc[2][2][4];
      conv_unit(lane_row + 2 * j * kIX + 8 * cg, wf, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const unsigned int p2 =
              bf162_bits(round_pre(acc[i >> 1][dy], i & 1)) & keep;
          const float lo = __uint_as_float(p2 << 16);
          const float hi = __uint_as_float(p2 & 0xffff0000u);
          sum[i] += lo;
          sq[i] = fmaf(lo, lo, sq[i]);  // f32: pre^2 does not fit bf16
          sum[i] += hi;
          sq[i] = fmaf(hi, hi, sq[i]);
        }
    }
  });
  __syncthreads();  // the staging buffers are free: the sums go through them
  block_channel_sums(sum, sq, reinterpret_cast<float*>(sm),
                     partials + static_cast<size_t>(blockIdx.x) * 2 * kCo);
}

// emit's output stage: a pooled tile, 64 bytes a pixel, whose four 16-byte
// channel chunks are XOR-swizzled by pixel. Index, in bf16 elements, of
// channel ch of the tile's pixel p.
__device__ __forceinline__ int out_stage_index(int p, int ch) {
  return p * kCo + ((((ch >> 3) ^ (p & 3)) << 3) | (ch & 7));
}

// A warp's two pooled rows of the staged tile -> out: 16 bytes a lane,
// neighbouring lanes on neighbouring addresses (a tile row is 1 KB
// contiguous); pooled pixels outside the image are not stored.
__device__ __forceinline__ void store_out_rows(
    const __nv_bfloat16* os, const Shape& s, const Tile& t, int warp, int lane,
    __nv_bfloat16* __restrict__ out) {
#pragma unroll
  for (int k = 0; k < 2 * kTPX * 4 / 32; ++k) {
    const int q = k * 32 + lane;
    const int p = warp * 2 * kTPX + (q >> 2), c = q & 3;
    const int py = t.py0 + p / kTPX, px = t.px0 + p % kTPX;
    if (py < s.ph && px < s.pw)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(t.img) * s.ph + py) * s.pw + px) * kCo +
          c * 8) =
          *reinterpret_cast<const uint4*>(os + out_stage_index(p, c * 8));
  }
}

// out[b, py, px, c] = max over the window of relu(bf16(bf16(pre * mul) + add)).
__global__ void __launch_bounds__(kThreads)
emit_tc_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ w, const float* __restrict__ vec,
               Shape s, __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(128) unsigned char sm[kXSmem + kGBytes];
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(sm + kXSmem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  unsigned int wf[2][3][4];
  load_weight_frags(w, gid, tig, wf);
  const uint2* lane_row = ldmatrix_lane_row(
      reinterpret_cast<const uint2*>(sm),
      reinterpret_cast<const uint2*>(sm) + kCopyPx, lane);
  // the affine of this thread's 4 channels, as pairs, in registers
  __nv_bfloat162 mul2[4], add2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mul2[i] = __float2bfloat162_rn(vec[kMul * kCo + gid + 8 * i]);
    add2[i] = __float2bfloat162_rn(vec[kAdd * kCo + gid + 8 * i]);
  }
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.0f);

  walk_staged_tiles(x, s, sm, [&](const Tile& tl) {
    // four units of a warp in flight: measured faster than two or eight
#pragma unroll 4
    for (int u = 0; u < 8; ++u) {
      const int j = 2 * warp + (u >> 2), cg = u & 3;
      float acc[2][2][4];
      conv_unit(lane_row + 2 * j * kIX + 8 * cg, wf, acc);
      const int p = j * kTPX + 4 * cg + tig;  // this thread's pooled pixel
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // col[hf] = the window's two column maxima (dx = 0, 1) of channel
        // gid + 8 (2 m + hf); then both channels' row maxima at once, and
        // the ReLU as a max with zero (max(relu(y)) = max(0, y...)). The
        // max of bf16 values is exact. A NaN comes through every max
        // (max.NaN), as it comes through relu and max_pool2d.
        __nv_bfloat162 col[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 2 * m + hf;
          col[hf] = __hmax2_nan(
              affine2(round_pre(acc[m][0], hf), mul2[i], add2[i]),
              affine2(round_pre(acc[m][1], hf), mul2[i], add2[i]));
        }
        const __nv_bfloat162 top = __hmax2_nan(
            __hmax2_nan(__lows2bfloat162(col[0], col[1]),
                        __highs2bfloat162(col[0], col[1])),
            zero2);
        os[out_stage_index(p, gid + 16 * m)] = __low2bfloat16(top);
        os[out_stage_index(p, gid + 16 * m + 8)] = __high2bfloat16(top);
      }
    }
    // a warp's units fill its own two pooled rows of the stage, so it
    // stores them itself, between two barriers of the warp alone
    __syncwarp();
    store_out_rows(os, s, tl, warp, lane, out);
    __syncwarp();
  });
}

// ---- backward, bf16 -----------------------------------------------------------

// kDw = false: partials[blockIdx.x] = (sum d [32], sum d * xhat [32]);
// kDw = true: partials[blockIdx.x][tap * 32 + co] = sum x[pixel + tap] *
// bf16(inv * (d - c0 - xhat * c1)); both over the block's tiles.
template <bool kDw>
__global__ void __launch_bounds__(kThreads, kDw ? 4 : 5)
bwd_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ vec,
              const __nv_bfloat16* __restrict__ gout, Shape s,
              float* __restrict__ partials) {
  __shared__ __align__(128) unsigned char sm[kTcSmem];
  uint2* xa = reinterpret_cast<uint2*>(sm);
  uint2* xb = xa + kCopyPx;
  unsigned char* raw = sm + 2 * kCopyPx * 8;
  unsigned char* gs = sm + kXSmem;
  ChannelConsts* cv = reinterpret_cast<ChannelConsts*>(gs + 2 * kGBytes);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  if (threadIdx.x < kCo) {
    const int k = threadIdx.x;
    ChannelConsts c;
    c.mean = vec[kMean * kCo + k];
    c.rinv = vec[kRinv * kCo + k];
    c.inv = vec[kInv * kCo + k];
    c.c1 = vec[kC1 * kCo + k];
    c.c0 = vec[kC0 * kCo + k];
    c.mul2 = __float2bfloat162_rn(vec[kMul * kCo + k]);  // bf16 values in f32
    c.add2 = __float2bfloat162_rn(vec[kAdd * kCo + k]);
    c.unused = 0.0f;
    cv[k] = c;
  }
  clear_copies(xa);
  unsigned int wf[2][3][4];
  load_weight_frags(w, gid, tig, wf);
  const uint2* lane_row = ldmatrix_lane_row(xa, xb, lane);

  float dw[2][6][4];   // dW^T [32 ch x 48 slots] of this warp (kDw)
  float sum_d[4], sum_dx[4];  // this thread's 4 channels (!kDw)
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < 6; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) dw[m][nt][r] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) sum_d[i] = sum_dx[i] = 0.0f;

  // the grid has at most one block a tile: every block has a first tile
  start_x_loads(x, s, tile_at(s, blockIdx.x), raw);
  start_g_loads(gout, s, tile_at(s, blockIdx.x), gs);
  cp_async_commit();

  int stage = 0;
  for (int t = blockIdx.x; t < s.tiles; t += gridDim.x, stage ^= 1) {
    const Tile tl = tile_at(s, t);
    cp_async_wait_all();  // this thread's loads of tile t have landed
    __syncthreads();      // everyone's have; the previous tile is computed
    if (t + gridDim.x < s.tiles) {
      const Tile nx = tile_at(s, t + gridDim.x);
      start_x_loads(x, s, nx, raw + (stage ^ 1) * kRawBytes);
      start_g_loads(gout, s, nx, gs + (stage ^ 1) * kGBytes);
    }
    cp_async_commit();
    stage_tile(x, s, tl, raw + stage * kRawBytes, xa, xb);
    __syncthreads();
    const unsigned short* gst =
        reinterpret_cast<const unsigned short*>(gs + stage * kGBytes);

    // units of 2 conv rows x 8 conv columns: pooled row j, pooled columns
    // 4 cg .. 4 cg + 3; this thread's pool window is (j, 4 cg + tig)
    // (two units in flight pay off only where registers allow: the sums)
#pragma unroll(kDw ? 1 : 2)
    for (int u = 0; u < 8; ++u) {
      const int j = 2 * warp + (u >> 2), cg = u & 3;
      // a pool window outside the image (ragged tiles) has a zero
      // cotangent, which adds nothing to the sums, and gets a zero d_pre
      [[maybe_unused]] const bool inside =
          tl.py0 + j < s.ph && tl.px0 + 4 * cg + tig < s.pw;
      const uint2* rows = lane_row + 2 * j * kIX + 8 * cg;

      float acc[2][2][4];  // [m][dy]: channels 16 m + gid (+ 8), columns dx
      conv_unit(rows, wf, acc);

      // epilogue on the fragments; af[m] = d_pre^T as product 2's A
      unsigned int af[2][4];
      const unsigned short* gp = gst + ((j * kTPX + 4 * cg + tig) * kCo);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = i >> 1, hf = i & 1;
        const int k = gid + 8 * i;
        const float gv = __uint_as_float(static_cast<unsigned int>(gp[k]) << 16);
        float pre[4], y[4];
        // pre and y exactly as emit_tc_kernel makes them
        const ChannelConsts cc = cv[k];
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const __nv_bfloat162 p2 = round_pre(acc[m][dy], hf);
          const __nv_bfloat162 y2 = affine2(p2, cc.mul2, cc.add2);
          pre[2 * dy] = __low2float(p2);
          pre[2 * dy + 1] = __high2float(p2);
          y[2 * dy] = __low2float(y2);
          y[2 * dy + 1] = __high2float(y2);
        }
        // route(), spelled for one winner: the cotangent passes only if the
        // window's max is positive, and then to the first y equal to it
        const float top = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
        const float gw = top > 0.0f ? gv : 0.0f;
        const bool w0 = y[0] == top;
        const bool w1 = !w0 && y[1] == top;
        const bool w2 = !w0 && !w1 && y[2] == top;
        if constexpr (kDw) {
          // d - c0 is gw - c0 at the winner and -c0 elsewhere
          const float at_w = __fsub_rn(gw, cc.c0), off_w = -cc.c0;
          const bool w3 = !w0 && !w1 && !w2;
          const bool wins[4] = {w0, w1, w2, w3};
          float dq[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float xh = __fmul_rn(__fsub_rn(pre[q], cc.mean), cc.rinv);
            const float inner =
                __fsub_rn(wins[q] ? at_w : off_w, __fmul_rn(xh, cc.c1));
            dq[q] = __fmul_rn(cc.inv, inner);
          }
          // pooled pixels outside the image give no d_pre
          af[m][hf] = inside ? pack_bf16x2(dq[0], dq[1]) : 0u;      // dy = 0
          af[m][2 + hf] = inside ? pack_bf16x2(dq[2], dq[3]) : 0u;  // dy = 1
        } else {
          // adding the three zeros of d and their products changes nothing
          const float pre_w = w0 ? pre[0] : w1 ? pre[1] : w2 ? pre[2] : pre[3];
          const float xh = __fmul_rn(__fsub_rn(pre_w, cc.mean), cc.rinv);
          sum_d[i] += gw;
          sum_dx[i] = fmaf(gw, xh, sum_dx[i]);
        }
      }

      // product 2: slots 8 nt .. 8 nt + 7 are row ky = nt / 2, half nt % 2;
      // the unit's pixels 0..7 are conv row 2 j, 8..15 conv row 2 j + 1
      if constexpr (kDw) {
        unsigned int tb[4][2];
        unsigned int r4[4];
        ldmatrix_x4_trans(rows, r4);
        tb[0][0] = r4[0]; tb[0][1] = r4[1]; tb[1][0] = r4[2]; tb[1][1] = r4[3];
        ldmatrix_x4_trans(rows + 2 * kIX, r4);
        tb[2][0] = r4[0]; tb[2][1] = r4[1]; tb[3][0] = r4[2]; tb[3][1] = r4[3];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nt = 0; nt < 6; ++nt)
            mma_bf16(dw[m][nt], af[m], tb[nt >> 1][nt & 1],
                     tb[(nt >> 1) + 1][nt & 1]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the staging buffers are free: the sums go through them

  float* red = reinterpret_cast<float*>(sm);
  if constexpr (kDw) {
    // the warps' tiles side by side, then added in warp order
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 6; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ch = m * 16 + gid + (r >> 1) * 8;
          const int n = nt * 8 + 2 * tig + (r & 1);
          red[(warp * kCo + ch) * kSlots + n] = dw[m][nt][r];
        }
    __syncthreads();
    float* out = partials + static_cast<size_t>(blockIdx.x) * kTaps * kCo;
    for (int o = threadIdx.x; o < kTaps * kCo; o += kThreads) {
      const int tap = o / kCo, co = o % kCo;
      const int n = (tap / 9) * 16 + ((tap % 9) / kCi) * 4 + tap % kCi;
      float sum = 0.0f;
      for (int wp = 0; wp < kWarps; ++wp)
        sum += red[(wp * kCo + co) * kSlots + n];
      out[o] = sum;
    }
  } else {
    block_channel_sums(sum_d, sum_dx, red,
                       partials + static_cast<size_t>(blockIdx.x) * 2 * kCo);
  }
}

// out[c] = sum over r < rows of partials[r * cols + c], in a fixed order:
// 8 row slices of 32 columns per block, then the slices in order.
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ partials, int rows, int cols,
              float* __restrict__ out) {
  __shared__ float sh[8][33];
  const int lane = threadIdx.x % 32;
  const int sl = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (c < cols)
    for (int r = sl; r < rows; r += 8)
      acc += partials[static_cast<size_t>(r) * cols + c];
  sh[sl][lane] = acc;
  __syncthreads();
  if (sl == 0 && c < cols) {
    float tot = 0.0f;
    for (int k = 0; k < 8; ++k) tot += sh[k][lane];
    out[c] = tot;
  }
}

// One wave of resident blocks, at most max_blocks (the partial buffer's
// rows) and at most one per tile.
template <typename K>
cudaError_t grid_for(K kernel, const Shape& s, int max_blocks, int* nblk) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  int n = (per_sm > 0 ? per_sm : 1) * sms;
  if (n > max_blocks) n = max_blocks;
  if (n > s.tiles) n = s.tiles;
  *nblk = n;
  return cudaSuccess;
}

cudaError_t reduce(const float* partials, int rows, int cols, float* out,
                   cudaStream_t stream) {
  PODTPU_LAUNCH(reduce_kernel, (cols + 31) / 32, 256, stream, partials, rows,
                cols, out);
  return cudaGetLastError();
}

bool bad_shape(int b, int h, int w, int halo) {
  return b <= 0 || h <= 0 || w <= 0 || h % 2 != 0 || w % 2 != 0 ||
         (halo != 0 && halo != 1);
}

// A kernel that leaves one row of `cols` partial sums per block, then the
// fixed-order sum of the rows. `args` are the kernel's arguments between
// the weights and the shape (none for stats; vec and g in the backward).
template <typename T, typename K, typename... A>
int sum_pass(K kernel, int cols, const void* x, const void* w, void* partials,
             int max_blocks, void* out, int b, int h, int wd, int halo,
             cudaStream_t stream, A... args) {
  const Shape s = make_shape(b, h, wd, halo);
  int nblk = 0;
  cudaError_t err = grid_for(kernel, s, max_blocks, &nblk);
  if (err != cudaSuccess) return static_cast<int>(err);
  PODTPU_LAUNCH(kernel, nblk, kThreads, stream, static_cast<const T*>(x),
                static_cast<const float*>(w), args..., s,
                static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(static_cast<const float*>(partials), nblk,
                                 cols, static_cast<float*>(out), stream));
}

template <typename T, typename K>
int emit_pass(K kernel, const void* x, const void* w, const void* vec,
              void* out, int b, int h, int wd, int halo,
              cudaStream_t stream) {
  const Shape s = make_shape(b, h, wd, halo);
  int nblk = 0;
  cudaError_t err = grid_for(kernel, s, 1 << 30, &nblk);
  if (err != cudaSuccess) return static_cast<int>(err);
  PODTPU_LAUNCH(kernel, nblk, kThreads, stream, static_cast<const T*>(x),
                static_cast<const float*>(w), static_cast<const float*>(vec),
                s, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernels move x, g and the pooled output in 16-byte pieces
// from 16-byte aligned addresses.
bool misaligned(const void* a, const void* b = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) != 0;
}

int bwd_entry(bool dw, const void* x, const void* w, const void* vec,
              const void* g, void* partials, int max_blocks, void* out, int b,
              int h, int wd, int bf16, int halo, void* stream) {
  if (bad_shape(b, h, wd, halo) || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int cols = dw ? kTaps * kCo : 2 * kCo;
#define PODTPU_BWD(T, kernel)                                              \
  sum_pass<T>(kernel, cols, x, w, partials, max_blocks, out, b, h, wd,    \
              halo, st,                                                    \
              static_cast<const float*>(vec), static_cast<const T*>(g))
  if (!bf16)
    return dw ? PODTPU_BWD(float, bwd_dw_kernel<float>)
              : PODTPU_BWD(float, bwd_sums_kernel<float>);
  if (misaligned(x, g)) return static_cast<int>(cudaErrorMisalignedAddress);
  return dw ? PODTPU_BWD(__nv_bfloat16, bwd_tc_kernel<true>)
            : PODTPU_BWD(__nv_bfloat16, bwd_tc_kernel<false>);
#undef PODTPU_BWD
}

}  // namespace

// Plain C entry points. x: [b, h, w, 3] NHWC in the compute dtype (bf16 when
// `bf16` is non-zero, else float32), or with `halo` = 1 [b, h + 2, w, 3]:
// a block of an image's rows with one row of each neighbour block, of
// which the kernels compute the h interior rows; w: [27, 32] float32 holding the
// compute-dtype weights, taps (ky, kx, ci); vec: [7, 32] float32 rows mul,
// add, mean, rinv, inv, c0, c1 (emit reads mul and add); g and the pooled
// output: [b, h/2, w/2, 32] in the compute dtype; partials: max_blocks rows
// of scratch (64 or 864 floats each). h and w must be even; in bf16 x, g
// and the pooled output must be 16-byte aligned. bf16 runs the tensor-core
// kernels, float32 the f32-pipe kernels. Each returns the cudaError_t of
// its launches (0 = launched).

extern "C" int podtpu_stem_stats(const void* x, const void* w, void* partials,
                                 int max_blocks, void* out, int b, int h,
                                 int wd, int bf16, int halo, void* stream) {
  if (bad_shape(b, h, wd, halo) || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return sum_pass<float>(stats_kernel<float>, 2 * kCo, x, w, partials,
                           max_blocks, out, b, h, wd, halo, st);
  if (misaligned(x)) return static_cast<int>(cudaErrorMisalignedAddress);
  return sum_pass<__nv_bfloat16>(stats_tc_kernel, 2 * kCo, x, w, partials,
                                 max_blocks, out, b, h, wd, halo, st);
}

extern "C" int podtpu_stem_emit(const void* x, const void* w, const void* vec,
                                void* out, int b, int h, int wd, int bf16,
                                int halo, void* stream) {
  if (bad_shape(b, h, wd, halo))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return emit_pass<float>(emit_kernel<float>, x, w, vec, out, b, h, wd, halo,
                            st);
  if (misaligned(x, out)) return static_cast<int>(cudaErrorMisalignedAddress);
  return emit_pass<__nv_bfloat16>(emit_tc_kernel, x, w, vec, out, b, h, wd,
                                  halo, st);
}

extern "C" int podtpu_stem_bwd_sums(const void* x, const void* w,
                                    const void* vec, const void* g,
                                    void* partials, int max_blocks, void* out,
                                    int b, int h, int wd, int bf16, int halo,
                                    void* stream) {
  return bwd_entry(false, x, w, vec, g, partials, max_blocks, out, b, h, wd,
                   bf16, halo, stream);
}

extern "C" int podtpu_stem_bwd_dw(const void* x, const void* w, const void* vec,
                                  const void* g, void* partials, int max_blocks,
                                  void* out, int b, int h, int wd, int bf16,
                                  int halo, void* stream) {
  return bwd_entry(true, x, w, vec, g, partials, max_blocks, out, b, h, wd,
                   bf16, halo, stream);
}
