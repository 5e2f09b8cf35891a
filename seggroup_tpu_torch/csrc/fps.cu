// Masked farthest-point sampling on Hopper (kernel K1 of the port).
//
// Replaces the TPU kernel seggroup_tpu/ops/pallas_fps.py:_fps_kernel
// (wrapper masked_fps_pallas) and implements seggroup_tpu_torch/ops/fps.py:
// masked_fps on the card; ops/cuda_fps.py builds and binds it.
//
// Semantics (those of seggroup_tpu/ops/fps.py:masked_fps with
// initial_idx=0, skip_initial=True): the first pick is the valid point
// farthest from candidate 0; each of the k-1 further picks is the argmax of
// the running minimum squared distance to the picks so far. Invalid points
// carry -1 and are never picked while a valid point remains; ties go to the
// lowest index. The squared distance is fma(dz,dz, fma(dy,dy, dx*dx)),
// written with intrinsics so that nvcc's own contraction cannot change it:
// that is the order in which XLA contracts jnp.sum(d*d, -1) on the CPU, and
// the order the plain PyTorch version emulates, so the three agree bit for
// bit.
//
// Design: one CTA of 256 threads per row. The row's xyz sits in shared
// memory as three SoA arrays (12 B per candidate: 12 KB at P=1024, 192 KB
// at the largest cap bucket P=16384, set through cudaFuncSetAttribute).
// Each thread keeps the running distances of its strided candidates in
// registers (PPT = ceil(P/256) of them, a template parameter). A step is a
// thread-local argmax, a warp shuffle reduction on (value, index) pairs, a
// shared-memory reduction across the 8 warps and a broadcast of the pick.
//
// What bounds it on an H100 SXM: the stage-1 call (B=512 rows, P=1024,
// k=64, 150,528 valid candidates in the bench scene) needs the xyz of the
// valid candidates and of each row's candidate 0 (12 B each), the 512 KB
// valid mask and the 131 KB output: about 2.5 MB, 0.73 us at 3.35 TB/s.
// It does 8 flops per valid candidate and pass, 8*64*150,528 = 77 MFLOP of
// f32, 1.15 us at 67 TFLOP/s. The bound is about 1.15 us and is set by the
// operations. What limits this design is the latency of the 64 dependent
// block reductions per row (two __syncthreads each); several rows per CTA
// is the next step.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sqdist(float px, float py, float pz,
                                        float ax, float ay, float az) {
  const float dx = __fsub_rn(px, ax);
  const float dy = __fsub_rn(py, ay);
  const float dz = __fsub_rn(pz, az);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// (value, index) argmax step: the larger value wins, ties go to the lower
// index.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide argmax of one (value, index) pair per thread; every thread
// gets the winning index.
__device__ __forceinline__ int block_argmax(float v, int i, float* red_v,
                                            int* red_i, int* chosen) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red_v[lane] : -INFINITY;
    i = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      take_better(v, i, ov, oi);
    }
    if (lane == 0) *chosen = i;
  }
  __syncthreads();
  return *chosen;
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
masked_fps_kernel(const float* __restrict__ xyz,
                  const uint8_t* __restrict__ valid,
                  int32_t* __restrict__ out, int P, int k) {
  extern __shared__ float soa[];  // x[P], y[P], z[P]
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int chosen;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* src = xyz + static_cast<size_t>(row) * P * 3;
  const uint8_t* vrow = valid + static_cast<size_t>(row) * P;
  int32_t* orow = out + static_cast<size_t>(row) * k;
  float* sx = soa;
  float* sy = soa + P;
  float* sz = soa + 2 * P;

  for (int t = tid; t < 3 * P; t += kThreads) {
    const int p = t / 3;
    soa[(t - 3 * p) * P + p] = src[t];
  }
  __syncthreads();

  // first pick: the valid point farthest from candidate 0
  float bv = -INFINITY;
  int bi = INT_MAX;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = tid + j * kThreads;
    if (p < P) {
      const float d = vrow[p] ? sqdist(sx[p], sy[p], sz[p], sx[0], sy[0], sz[0])
                              : -1.0f;
      take_better(bv, bi, d, p);
    }
  }
  int cur = block_argmax(bv, bi, red_v, red_i, &chosen);
  if (tid == 0) orow[0] = cur;

  // running min distance to the picks; invalid = -1, padding slots = -inf
  float min_d[PPT];
  {
    const float ax = sx[cur], ay = sy[cur], az = sz[cur];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = tid + j * kThreads;
      min_d[j] = p < P ? (vrow[p] ? sqdist(sx[p], sy[p], sz[p], ax, ay, az)
                                  : -1.0f)
                       : -INFINITY;
    }
  }

  for (int s = 1; s < k; ++s) {
    bv = -INFINITY;
    bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PPT; ++j) take_better(bv, bi, min_d[j], tid + j * kThreads);
    cur = block_argmax(bv, bi, red_v, red_i, &chosen);
    if (tid == 0) orow[s] = cur;
    if (s + 1 < k) {
      const float ax = sx[cur], ay = sy[cur], az = sz[cur];
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int p = tid + j * kThreads;
        // valid candidates are exactly those with a distance >= 0
        if (min_d[j] >= 0.0f)
          min_d[j] = fminf(min_d[j], sqdist(sx[p], sy[p], sz[p], ax, ay, az));
      }
    }
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, const uint8_t* valid, int32_t* out,
                   int B, int P, int k, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3) * P * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        masked_fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  masked_fps_kernel<PPT><<<B, kThreads, smem, stream>>>(xyz, valid, out, P, k);
  return cudaGetLastError();
}

}  // namespace

// Largest candidate count per row the kernel takes (192 KB of shared memory).
extern "C" int seggroup_fps_max_points() { return 64 * kThreads; }

// xyz: (B, P, 3) f32 contiguous; valid: (B, P) bool (one byte each);
// out: (B, k) int32. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int seggroup_masked_fps(const void* xyz, const void* valid, void* out,
                                   int B, int P, int k, int device,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B <= 0 || P <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(xyz);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (P <= 1 * kThreads) e = launch<1>(x, v, o, B, P, k, st);
  else if (P <= 2 * kThreads) e = launch<2>(x, v, o, B, P, k, st);
  else if (P <= 4 * kThreads) e = launch<4>(x, v, o, B, P, k, st);
  else if (P <= 8 * kThreads) e = launch<8>(x, v, o, B, P, k, st);
  else if (P <= 16 * kThreads) e = launch<16>(x, v, o, B, P, k, st);
  else if (P <= 32 * kThreads) e = launch<32>(x, v, o, B, P, k, st);
  else if (P <= 64 * kThreads) e = launch<64>(x, v, o, B, P, k, st);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
