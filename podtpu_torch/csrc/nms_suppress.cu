// Greedy class-aware NMS suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel podtpu/ops/pallas/nms_kernel.py
// (pallas_greedy_suppress -> _suppress_kernel). Computes the same function:
// for score-sorted, class-offset xyxy boxes of one image, box j is removed
// when a box i < j that is still kept overlaps it with
// iou = inter / (a_i + a_j - inter + 1e-6) > thr; keep starts as `valid`.
//
// What bounds it on this card: latency, not bytes or operations. An image
// is K = 512 boxes (8 KB) and the loop over i is sequential, one block-wide
// barrier per kept box. The TPU kernel parks the whole [K, K] suppression
// matrix in VMEM; here nothing of size K^2 exists: one block per image
// stages its boxes, their areas and a keep byte per box in shared memory,
// and each kept i computes its IoU row only against the j > i still kept.
// Rows of removed boxes cost no barrier (keep[i] is block-uniform), and the
// loop stops after the last valid box.
//
// Why only j > i: IoU is symmetric bit for bit (min, max and + commute), so
// a kept i never overlaps a kept j < i above thr -- j would have removed i.
// The dense reference's clears of j < i are therefore no-ops.
//
// Bit-exactness with the plain PyTorch version: built with --fmad=false (no
// contraction of a_i + a_j - iw*ih into an FMA) and without fast math (IEEE
// division). Class offsets reach ~3e5, where a changed rounding flips
// suppressions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
suppress_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep_out, int k, float thr) {
  extern __shared__ float4 smem[];
  float4* sbox = smem;                                  // [k]
  float* sarea = reinterpret_cast<float*>(sbox + k);    // [k]
  uint8_t* skeep = reinterpret_cast<uint8_t*>(sarea + k);  // [k]
  __shared__ int last;

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  if (tid == 0) last = -1;
  __syncthreads();

  int my_last = -1;
  for (int j = tid; j < k; j += kThreads) {
    const float4 b = boxes[base + j];
    sbox[j] = b;
    sarea[j] = (b.z - b.x) * (b.w - b.y);
    const uint8_t v = valid[base + j] != 0;
    skeep[j] = v;
    if (v) my_last = j;
  }
  if (my_last >= 0) atomicMax(&last, my_last);
  __syncthreads();

  const int n = last + 1;
  for (int i = 0; i < n; ++i) {
    if (!skeep[i]) continue;  // block-uniform: written before the last barrier
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    for (int j = i + 1 + tid; j < n; j += kThreads) {
      if (!skeep[j]) continue;
      const float4 bj = sbox[j];
      const float iw = fmaxf(fminf(bi.z, bj.z) - fmaxf(bi.x, bj.x), 0.0f);
      const float ih = fmaxf(fminf(bi.w, bj.w) - fmaxf(bi.y, bj.y), 0.0f);
      const float inter = iw * ih;
      const float iou = inter / (ai + sarea[j] - inter + 1e-6f);
      if (iou > thr) skeep[j] = 0;
    }
    __syncthreads();
  }

  for (int j = tid; j < k; j += kThreads) keep_out[base + j] = skeep[j];
}

}  // namespace

// boxes [b, k, 4] float32, valid [b, k] bool (uint8), keep [b, k] bool.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int podtpu_nms_suppress(const void* boxes, const void* valid,
                                   void* keep, int b, int k, float thr,
                                   void* stream) {
  const size_t smem = static_cast<size_t>(k) * (sizeof(float4) + sizeof(float) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  suppress_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}
