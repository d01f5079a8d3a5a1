// A mock of the small subset of CUDA that podtpu_torch/csrc/*.cu use, so
// that g++ can compile a kernel source as host C++ and its logic (indexing,
// barriers, reductions, fragment layouts) can run on CPU threads where there
// is no card and no nvcc:
//
//   g++ -std=c++20 -O1 -ffp-contract=off -pthread -shared -fPIC -x c++ \
//       -I tools/cuda_mock -o stem_fused_mock.so podtpu_torch/csrc/stem_fused.cu
//
// The library exports the source's C entry points; call them with CPU
// pointers and a null stream (tests/test_torch_stem_mock.py and
// tests/test_torch_nms_mock.py do).
//
// One std::thread per CUDA thread, a std::barrier per block for
// __syncthreads and one per warp for the warp-wide instructions; blocks run
// one after another. The PTX instructions and warp intrinsics the sources
// wrap in functions (cp.async, ldmatrix, mma.sync, shfl, ballot) are
// emulated here by their documented lane -> row / column layouts: cp.async
// copies are queued and carried out only by the wait that covers their
// group, so a missing wait shows as missing data. It says nothing about
// speed, bank conflicts or what nvcc accepts.
#pragma once
#define PODTPU_CUDA_MOCK 1
#define PODTPU_PTX_EMULATED 1

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

// ---- types -----------------------------------------------------------------
struct uint3 { unsigned int x, y, z; };
struct dim3 { unsigned int x = 1, y = 1, z = 1; };
struct float4 { float x, y, z, w; };
struct alignas(8) uint2 { unsigned int x, y; };
struct alignas(16) uint4 { unsigned int x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline uint2 make_uint2(unsigned int x, unsigned int y) { return {x, y}; }

struct __nv_bfloat16 { uint16_t bits; };

inline float __uint_as_float(unsigned int u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned int __float_as_uint(float f) { unsigned int u; std::memcpy(&u, &f, 4); return u; }
inline float __bfloat162float(__nv_bfloat16 v) { return __uint_as_float(static_cast<unsigned int>(v.bits) << 16); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned int u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<uint16_t>(0x7fff)};  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);  // round to nearest even
  return {static_cast<uint16_t>(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.bits; }
struct alignas(4) __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) { return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)}; }
inline __nv_bfloat162 __float2bfloat162_rn(float v) { return __floats2bfloat162_rn(v, v); }
inline __nv_bfloat16 __low2bfloat16(__nv_bfloat162 v) { return v.x; }
inline __nv_bfloat16 __high2bfloat16(__nv_bfloat162 v) { return v.y; }
inline __nv_bfloat162 __lows2bfloat162(__nv_bfloat162 a, __nv_bfloat162 b) { return {a.x, b.x}; }
inline __nv_bfloat162 __highs2bfloat162(__nv_bfloat162 a, __nv_bfloat162 b) { return {a.y, b.y}; }
// max.NaN: a NaN operand gives the canonical NaN; +0 is above -0
inline __nv_bfloat16 cuda_mock_max_nan(__nv_bfloat16 a, __nv_bfloat16 b) {
  const float fa = __uint_as_float(static_cast<unsigned int>(a.bits) << 16);
  const float fb = __uint_as_float(static_cast<unsigned int>(b.bits) << 16);
  if (std::isnan(fa) || std::isnan(fb)) return {static_cast<uint16_t>(0x7fff)};
  if (fa == fb) return {static_cast<uint16_t>(a.bits & b.bits)};  // -0 only if both
  return fa > fb ? a : b;
}
inline __nv_bfloat162 __hmax2_nan(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {cuda_mock_max_nan(a.x, b.x), cuda_mock_max_nan(a.y, b.y)};
}
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
// one rounding of the exact result (computed in double: exact for bf16 operands)
inline __nv_bfloat16 cuda_mock_round_bf16(double v) {
  float f = static_cast<float>(v);  // may round twice; repaired below
  __nv_bfloat16 r = __float2bfloat16_rn(f);
  // candidates around r: pick the nearest to v, ties to even
  __nv_bfloat16 best = r;
  double err = std::fabs(static_cast<double>(__bfloat162float(r)) - v);
  for (int d = -1; d <= 1; d += 2) {
    __nv_bfloat16 c{static_cast<uint16_t>(r.bits + d)};
    const double e = std::fabs(static_cast<double>(__bfloat162float(c)) - v);
    if (std::isfinite(__bfloat162float(c)) && (e < err || (e == err && !(c.bits & 1)))) { best = c; err = e; }
  }
  return best;
}
inline __nv_bfloat162 __hmul2_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {cuda_mock_round_bf16(static_cast<double>(__bfloat162float(a.x)) * __bfloat162float(b.x)),
          cuda_mock_round_bf16(static_cast<double>(__bfloat162float(a.y)) * __bfloat162float(b.y))};
}
inline __nv_bfloat162 __hadd2_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {cuda_mock_round_bf16(static_cast<double>(__bfloat162float(a.x)) + __bfloat162float(b.x)),
          cuda_mock_round_bf16(static_cast<double>(__bfloat162float(a.y)) + __bfloat162float(b.y))};
}
// built with -ffp-contract=off: each of these rounds once, as the intrinsic
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
// 1 + the index of the lowest set bit (0 for 0); leading zeros
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __clzll(long long x) {
  return x ? __builtin_clzll(static_cast<unsigned long long>(x)) : 64;
}

// ---- the running thread's place in the grid -----------------------------------
namespace cuda_mock {

struct Warp {
  std::barrier<> bar{32};
  const void* ptr[32];
  unsigned int reg[32][8];
  float val[32];
};

struct Block {
  explicit Block(int threads) : bar(threads), warps((threads + 31) / 32) {}
  std::barrier<> bar;
  std::vector<Warp> warps;
};

// a cp.async: `bytes` copied, the rest of its `span` zero-filled
struct PendingCopy { void* dst; const void* src; int bytes; int span = 16; };

inline thread_local Block* block = nullptr;
inline thread_local std::vector<PendingCopy> pending;
// pending.size() at each commit still in flight, oldest first
inline thread_local std::vector<size_t> groups;

// Carries out the first n pending copies.
inline void carry_out(size_t n) {
  for (size_t i = 0; i < n; ++i) {
    std::memset(pending[i].dst, 0, pending[i].span);
    std::memcpy(pending[i].dst, pending[i].src, pending[i].bytes);
  }
  pending.erase(pending.begin(), pending.begin() + n);
  for (auto& g : groups) g = g > n ? g - n : 0;
}

}  // namespace cuda_mock

inline thread_local uint3 threadIdx{0, 0, 0};
inline thread_local uint3 blockIdx{0, 0, 0};
inline thread_local dim3 gridDim;
inline thread_local dim3 blockDim;

namespace cuda_mock {
inline Warp& warp() { return block->warps[threadIdx.x / 32]; }
}  // namespace cuda_mock

inline void __syncthreads() { cuda_mock::block->bar.arrive_and_wait(); }

inline void __syncwarp() { cuda_mock::warp().bar.arrive_and_wait(); }

namespace cuda_mock {

// Runs kernel(args...) on grid blocks of `threads` threads, one block at a
// time. Blocks of fewer than 32 threads per warp are not supported by the
// warp-wide instructions.
template <typename K, typename... A>
void launch(K kernel, int grid, int threads, A... args) {
  for (int b = 0; b < grid; ++b) {
    Block blk(threads);
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, b, t] {
        threadIdx = {static_cast<unsigned int>(t), 0, 0};
        blockIdx = {static_cast<unsigned int>(b), 0, 0};
        gridDim.x = grid;
        blockDim.x = threads;
        block = &blk;
        pending.clear();
        groups.clear();
        kernel(args...);
      });
    for (auto& th : pool) th.join();
  }
}

}  // namespace cuda_mock

#define PODTPU_LAUNCH(kernel, grid, block, stream, ...) \
  cuda_mock::launch(kernel, grid, block, __VA_ARGS__)

// ---- the emulated PTX ------------------------------------------------------------
namespace {

inline void cp_async16(void* dst, const void* src, int bytes) {
  cuda_mock::pending.push_back({dst, src, bytes});
}
inline void cp_async8(void* dst, const void* src) {
  if (reinterpret_cast<uintptr_t>(dst) % 8 || reinterpret_cast<uintptr_t>(src) % 8)
    std::abort();
  cuda_mock::pending.push_back({dst, src, 8, 8});
}
inline void cp_async_commit() { cuda_mock::groups.push_back(cuda_mock::pending.size()); }
inline void cp_async_wait_all() {
  cuda_mock::carry_out(cuda_mock::pending.size());
  cuda_mock::groups.clear();
}
// cp.async.wait_group N: every committed group but the newest N is done
template <int N>
inline void cp_async_wait_group() {
  auto& g = cuda_mock::groups;
  if (g.size() <= N) return;
  cuda_mock::carry_out(g[g.size() - 1 - N]);
  g.erase(g.begin(), g.end() - N);
}

inline void ldmatrix_impl(const void* row, unsigned int (&r)[4], bool trans) {
  auto& w = cuda_mock::warp();
  const int lane = threadIdx.x % 32;
  if (reinterpret_cast<uintptr_t>(row) % 16) std::abort();  // 16-byte rows
  w.ptr[lane] = row;
  w.bar.arrive_and_wait();
  for (int m = 0; m < 4; ++m) {
    uint16_t e[2];
    for (int k = 0; k < 2; ++k) {
      const int rr = trans ? 2 * (lane % 4) + k : lane / 4;
      const int cc = trans ? lane / 4 : 2 * (lane % 4) + k;
      e[k] = static_cast<const uint16_t*>(w.ptr[m * 8 + rr])[cc];
    }
    r[m] = static_cast<unsigned int>(e[0]) | (static_cast<unsigned int>(e[1]) << 16);
  }
  w.bar.arrive_and_wait();
}
inline void ldmatrix_x4(const void* row, unsigned int (&r)[4]) { ldmatrix_impl(row, r, false); }
inline void ldmatrix_x4_trans(const void* row, unsigned int (&r)[4]) { ldmatrix_impl(row, r, true); }

inline float bf16_half(unsigned int reg, int hi) {
  return __uint_as_float(hi ? (reg & 0xffff0000u) : (reg << 16));
}

// m16n8k16: every lane posts its fragments, then computes its own four
// outputs from the whole of A and B (sums in double, rounded once).
inline void mma_bf16(float (&c)[4], const unsigned int (&a)[4], unsigned int b0, unsigned int b1) {
  auto& w = cuda_mock::warp();
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) w.reg[lane][i] = a[i];
  w.reg[lane][4] = b0;
  w.reg[lane][5] = b1;
  w.bar.arrive_and_wait();
  const auto a_at = [&](int row, int col) {  // A[16 x 16]
    const int g = row % 8, t = (col % 8) / 2;
    const int reg = (row / 8) + 2 * (col / 8);
    return bf16_half(w.reg[g * 4 + t][reg], col % 2);
  };
  const auto b_at = [&](int k, int n) {  // B[16 x 8]
    const int t = (k % 8) / 2;
    return bf16_half(w.reg[n * 4 + t][4 + k / 8], k % 2);
  };
  const int g = lane / 4, t = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i / 2) * 8, col = 2 * t + i % 2;
    double acc = c[i];
    for (int k = 0; k < 16; ++k) acc += static_cast<double>(a_at(row, k)) * b_at(k, col);
    c[i] = static_cast<float>(acc);
  }
  w.bar.arrive_and_wait();
}

inline unsigned int ballot(bool p) {
  auto& w = cuda_mock::warp();
  const int lane = threadIdx.x % 32;
  w.reg[lane][0] = p;
  w.bar.arrive_and_wait();
  unsigned int bits = 0;
  for (int l = 0; l < 32; ++l) bits |= (w.reg[l][0] ? 1u : 0u) << l;
  w.bar.arrive_and_wait();
  return bits;
}

inline unsigned int shfl_xor_bits(unsigned int v, int lane_mask) {
  auto& w = cuda_mock::warp();
  const int lane = threadIdx.x % 32;
  w.reg[lane][0] = v;
  w.bar.arrive_and_wait();
  const unsigned int got = w.reg[lane ^ lane_mask][0];
  w.bar.arrive_and_wait();
  return got;
}

inline float shfl_xor(float v, int lane_mask) {
  auto& w = cuda_mock::warp();
  const int lane = threadIdx.x % 32;
  w.val[lane] = v;
  w.bar.arrive_and_wait();
  const float got = w.val[lane ^ lane_mask];
  w.bar.arrive_and_wait();
  return got;
}

}  // namespace

// ---- the runtime calls the launchers make ----------------------------------------
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// PODTPU_MOCK_SMS: how many blocks a persistent kernel's grid gets (default
// 2, so that a block walks several tiles).
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) {
  const char* env = std::getenv("PODTPU_MOCK_SMS");
  *value = env ? std::atoi(env) : 2;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
