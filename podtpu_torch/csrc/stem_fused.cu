// Fused Darknet stem for Hopper (sm_90a): conv3x3 (3 -> 32, stride 1, pad 1),
// train-mode BatchNorm, ReLU and the following 2x2/2 max pool, forward and
// backward, in four kernels and one fixed-order reduction.
//
// Replaces the four Pallas TPU kernels of podtpu/ops/pallas/stem_fused.py
// (make_fused_stem):
//   stats_kernel    <- run_stats    (:314, body :189-207)
//   emit_kernel     <- run_emit     (:326, body :209-230)
//   bwd_sums_kernel <- run_bwd_sums (:339, body :232-272)
//   bwd_dw_kernel   <- run_bwd_dw   (:352, body :274-312)
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
// cotangent (177 MB), and nothing else. That leaves the conv's 27 x 32
// multiply-adds per pixel (19 GFLOP a pass at B=64) as the bound of this
// design: it runs them on the f32 pipes (products of bf16 values are exact
// in f32, as in the tensor cores), not on the tensor cores, which would
// need the im2col tile to be staged for wgmma. The TPU kernel's MXU
// formulation (block-diagonal weights, parity-split planar input) exists
// for the TPU's matrix unit and is not carried over.
//
// Design. A block owns a tile of 8 x 16 pooled pixels (16 x 32 conv
// pixels) at a time and walks the tiles of the whole batch in a fixed
// order (tile = blockIdx.x + k * gridDim.x; one wave of blocks). It stages
// the tile's 18 x 34 x 3 input (with the conv's halo and zero padding) and
// the 864 weights in shared memory; each of its 128 threads takes one
// pooled pixel: the 4 x 4 x 3 input patch in registers, the four conv
// outputs of its 2x2 window for 8 channels at a time.
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
// * Rounding: the conv accumulates in f32 with fmaf in tap order
//   (ky, kx, ci) and rounds once to T (the XLA and Pallas rounding point,
//   stem_fused.py:156). The affine is two separately rounded operations
//   (__fmul_rn, __fadd_rn), each rounded to T, as the plain x * mul + add
//   rounds; the build's --fmad=false keeps nvcc from contracting them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

struct Shape {
  int b, h, w, ph, pw, tiles_y, tiles_x, tiles;
};

Shape make_shape(int b, int h, int w) {
  Shape s;
  s.b = b;
  s.h = h;
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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an f32 value to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 consecutive values of T <-> f32 (16- or 32-byte aligned).
__device__ __forceinline__ void load8(const float* src, float (&v)[kGroup]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&v)[kGroup]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[kGroup]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  return static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&v)[kGroup]) {
  uint4 u;
  u.x = pack_bf16x2(v[0], v[1]);
  u.y = pack_bf16x2(v[2], v[3]);
  u.z = pack_bf16x2(v[4], v[5]);
  u.w = pack_bf16x2(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             float* ws) {
  for (int i = threadIdx.x; i < kTaps * kCo; i += kThreads) ws[i] = w[i];
}

__device__ __forceinline__ void load_vec(const float* __restrict__ vec,
                                         int rows, float* vs) {
  for (int i = threadIdx.x; i < rows * kCo; i += kThreads) vs[i] = vec[i];
}

// xs[(r * kIX + c) * kCi + ci] = x[img, 2*py0 - 1 + r, 2*px0 - 1 + c, ci],
// zero outside the image (the conv's padding).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x,
                                          const Shape& s, const Tile& t,
                                          float* xs) {
  const int y0 = 2 * t.py0 - 1;
  const int x0 = 2 * t.px0 - 1;
  const T* img = x + static_cast<size_t>(t.img) * s.h * s.w * kCi;
  for (int i = threadIdx.x; i < kTileIn; i += kThreads) {
    const int ci = i % kCi;
    const int rc = i / kCi;
    const int c = rc % kIX;
    const int r = rc / kIX;
    const int yy = y0 + r;
    const int xx = x0 + c;
    float v = 0.0f;
    if (yy >= 0 && yy < s.h && xx >= 0 && xx < s.w)
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
  reduce_kernel<<<(cols + 31) / 32, 256, 0, stream>>>(partials, rows, cols, out);
  return cudaGetLastError();
}

bool bad_shape(int b, int h, int w) {
  return b <= 0 || h <= 0 || w <= 0 || h % 2 != 0 || w % 2 != 0;
}

template <typename T>
int stats(const void* x, const void* w, void* partials, int max_blocks,
          void* out, int b, int h, int wd, cudaStream_t stream) {
  const Shape s = make_shape(b, h, wd);
  int nblk = 0;
  cudaError_t err = grid_for(stats_kernel<T>, s, max_blocks, &nblk);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_kernel<T><<<nblk, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), s,
      static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(static_cast<const float*>(partials), nblk,
                                 2 * kCo, static_cast<float*>(out), stream));
}

template <typename T>
int emit(const void* x, const void* w, const void* vec, void* out, int b,
         int h, int wd, cudaStream_t stream) {
  const Shape s = make_shape(b, h, wd);
  int nblk = 0;
  cudaError_t err = grid_for(emit_kernel<T>, s, 1 << 30, &nblk);
  if (err != cudaSuccess) return static_cast<int>(err);
  emit_kernel<T><<<nblk, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(vec), s, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_sums(const void* x, const void* w, const void* vec, const void* g,
             void* partials, int max_blocks, void* out, int b, int h, int wd,
             cudaStream_t stream) {
  const Shape s = make_shape(b, h, wd);
  int nblk = 0;
  cudaError_t err = grid_for(bwd_sums_kernel<T>, s, max_blocks, &nblk);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_sums_kernel<T><<<nblk, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(vec), static_cast<const T*>(g), s,
      static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(static_cast<const float*>(partials), nblk,
                                 2 * kCo, static_cast<float*>(out), stream));
}

template <typename T>
int bwd_dw(const void* x, const void* w, const void* vec, const void* g,
           void* partials, int max_blocks, void* out, int b, int h, int wd,
           cudaStream_t stream) {
  const Shape s = make_shape(b, h, wd);
  int nblk = 0;
  cudaError_t err = grid_for(bwd_dw_kernel<T>, s, max_blocks, &nblk);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dw_kernel<T><<<nblk, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(vec), static_cast<const T*>(g), s,
      static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(static_cast<const float*>(partials), nblk,
                                 kTaps * kCo, static_cast<float*>(out), stream));
}

}  // namespace

// Plain C entry points. x: [b, h, w, 3] NHWC in the compute dtype (bf16 when
// `bf16` is non-zero, else float32); w: [27, 32] float32 holding the
// compute-dtype weights, taps (ky, kx, ci); vec: [7, 32] float32 rows mul,
// add, mean, rinv, inv, c0, c1 (emit reads mul and add); g and the pooled
// output: [b, h/2, w/2, 32] in the compute dtype; partials: max_blocks rows
// of scratch (64 or 864 floats each). h and w must be even. Each returns
// the cudaError_t of its launches (0 = launched).

extern "C" int podtpu_stem_stats(const void* x, const void* w, void* partials,
                                 int max_blocks, void* out, int b, int h,
                                 int wd, int bf16, void* stream) {
  if (bad_shape(b, h, wd) || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? stats<__nv_bfloat16>(x, w, partials, max_blocks, out, b, h, wd, st)
              : stats<float>(x, w, partials, max_blocks, out, b, h, wd, st);
}

extern "C" int podtpu_stem_emit(const void* x, const void* w, const void* vec,
                                void* out, int b, int h, int wd, int bf16,
                                void* stream) {
  if (bad_shape(b, h, wd)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? emit<__nv_bfloat16>(x, w, vec, out, b, h, wd, st)
              : emit<float>(x, w, vec, out, b, h, wd, st);
}

extern "C" int podtpu_stem_bwd_sums(const void* x, const void* w,
                                    const void* vec, const void* g,
                                    void* partials, int max_blocks, void* out,
                                    int b, int h, int wd, int bf16,
                                    void* stream) {
  if (bad_shape(b, h, wd) || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd_sums<__nv_bfloat16>(x, w, vec, g, partials, max_blocks, out,
                                        b, h, wd, st)
              : bwd_sums<float>(x, w, vec, g, partials, max_blocks, out, b, h,
                                wd, st);
}

extern "C" int podtpu_stem_bwd_dw(const void* x, const void* w, const void* vec,
                                  const void* g, void* partials, int max_blocks,
                                  void* out, int b, int h, int wd, int bf16,
                                  void* stream) {
  if (bad_shape(b, h, wd) || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd_dw<__nv_bfloat16>(x, w, vec, g, partials, max_blocks, out,
                                      b, h, wd, st)
              : bwd_dw<float>(x, w, vec, g, partials, max_blocks, out, b, h, wd,
                              st);
}
