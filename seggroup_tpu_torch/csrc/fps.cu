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
// The k picks form a chain: each step's argmax needs the previous step's
// pick. No design takes fewer than k dependent steps, so the time of one
// step is what a design can shorten.
//
// Two designs, chosen by P (ops/cuda_fps.variant):
//
// Warps (P <= 4,096; the stage-1 call has P = 1,024). One CTA of 4 warps
// per row. Lane l of warp w keeps candidates (j * 4 + w) * 32 + l, j = 0 ..
// SLOTS-1, in registers: coordinates and running distance. A step: the
// lane's slots take the min with the last pick's distance (no branch in the
// pass, so the slots' arithmetic interleaves) and their argmax as a tree of
// pairs (the lower slot kept on a tie); two redux.sync give the warp's
// largest distance, compared as the signed integers of its bits, and the
// lowest index holding it; the 4 warps' pairs meet in shared memory behind
// one __syncthreads. The row's warps run only the slots up to the row's
// last valid candidate (counted exactly up to 8, a power of two above; at
// the stage-1 call most rows are short valid prefixes), all on one code
// path to their barriers. The picked point's coordinates come back through
// L1.
//
// Block (4,096 < P <= 16,384, the largest cap bucket). One CTA of 256
// threads per row, the row's xyz in shared memory as three SoA arrays (12 B
// per candidate: 192 KB at P = 16,384), each thread keeping the running
// distances of its strided candidates in registers; a step is a
// thread-local argmax, a warp shuffle reduction on (value, index) pairs, a
// shared-memory reduction across the 8 warps and a broadcast of the pick.
//
// What bounds it on an H100 SXM: the stage-1 call (B=512 rows, P=1024,
// k=64, 150,528 valid candidates in the bench scene) needs the xyz of the
// valid candidates and of each row's candidate 0 (12 B each), the 512 KB
// valid mask and the 131 KB output: about 2.5 MB, 0.73 us at 3.35 TB/s.
// It does 8 flops per valid candidate and pass, 8*64*150,528 = 77 MFLOP of
// f32, 1.15 us at 67 TFLOP/s. The roofline bound is about 1.15 us, set by
// the operations; the chain of 64 dependent steps is what the kernel's time
// is made of (chip_smoke.py prints the time per step beside the bound).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, in turns against the
// previous design (the block design below, then used at every P), 50
// launches queued behind a spin: the stage-1 call 0.0182 ms against 0.0549,
// 0.28 us a step (the bound's 1.15 us is 16 times less than the whole); 64
// full rows of 1,024 0.0162 against 0.0399, of 2,048 0.0190 against 0.0604,
// of 4,096 0.0287 against 0.0999 (the crossover in ops/cuda_fps.py). One
// warp per row took 0.0252 at the stage-1 call: a full row's 32 slots on one
// scheduler, about 370 cycles of fixed latency a step (the redux pair, the
// pick's read, the dependent arithmetic) and 11 a slot; 2 warps per row
// 0.0242. Each slot's own branch (skipping dead slots slot by slot) kept the
// slots' arithmetic from overlapping: 0.0386. Exact slot counts below 8
// (rather than powers of two alone) take the stage-1 call from 0.0223 to
// 0.0182 ms (287 of its 512 rows end at slot 5, 224 are empty) and cost full
// rows of 1,024 9% on 64 rows (0.0163 against 0.0148) and 3% on 512 (0.0281
// against 0.0273), the code of the 8-slot path being the same; the stage-1
// call is the one the model makes.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 4;  // warps per row (one CTA) of the warps design
constexpr int kThreads = 256;  // threads per CTA of the block design
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sqdist(float px, float py, float pz,
                                        float ax, float ay, float az) {
  const float dx = __fsub_rn(px, ax);
  const float dy = __fsub_rn(py, ay);
  const float dz = __fsub_rn(pz, az);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// The lane's argmax over its slots 0..N-1 (value, slot) as a tree of
// pairs, the lower slots always on the left and kept on a tie, so that a
// tie goes to the lowest slot; log2(N) levels, the values by fmaxf so that
// only the slot's select waits on the compare.
template <int N>
__device__ __forceinline__ void lane_argmax(const float* d, float& bv, int& bj) {
  float v[N];
  int j[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = d[i];
    j[i] = i;
  }
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) {
      j[i] = v[i + w] > v[i] ? j[i + w] : j[i];
      v[i] = fmaxf(v[i], v[i + w]);
    }
  }
  bv = v[0];
  bj = j[0];
}

// The row's argmax: each lane offers its best (value, index); every lane of
// the row's kRowWarps warps gets the index of the largest value, the
// lowest such index on a tie. Values are compared as the signed integers of
// their bits: that orders the distances (>= 0) and puts every negative mark
// (-1 invalid, -inf padding) below them, and a row reaches here only with a
// valid candidate. Two redux.sync give the warp's pair; the warps' pairs
// meet in shared memory, one buffer per step parity, behind a barrier of
// the CTA's warps.
__device__ __forceinline__ int row_argmax(float v, int i, int s, int2 (*xch)[kRowWarps]) {
  const int key = __float_as_int(v);
  const int best = __reduce_max_sync(kFull, key);
  const int idx = __reduce_min_sync(kFull, key == best ? i : INT_MAX);
  if ((threadIdx.x & 31) == 0) xch[s & 1][threadIdx.x >> 5] = make_int2(best, idx);
  __syncthreads();
  int2 top[kRowWarps];
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) top[w] = xch[s & 1][w];
#pragma unroll
  for (int w = 1; w < kRowWarps; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < kRowWarps; i += 2 * w) {
      const int2 o = top[i + w];
      if (o.x > top[i].x || (o.x == top[i].x && o.y < top[i].y)) top[i] = o;
    }
  }
  return top[0].y;
}

// The k picks of one row over the first N slots (no warp of the row has a
// valid candidate in the others); d holds 0 for a valid candidate, -1 for
// an invalid one, -inf for padding; slot j of lane l of warp w is candidate
// (j * kRowWarps + w) * 32 + l. No branch inside a step's pass over the
// slots, so the slots' arithmetic interleaves.
template <int SLOTS, int N>
__device__ __forceinline__ void row_picks(const float (&px)[SLOTS], const float (&py)[SLOTS],
                                          const float (&pz)[SLOTS], float (&d)[SLOTS],
                                          const float* __restrict__ src,
                                          int32_t* __restrict__ orow, int k,
                                          int2 (*xch)[kRowWarps]) {
  const int lane = threadIdx.x & 31;
  const int part = threadIdx.x >> 5;
  // first pick: the valid point farthest from candidate 0
  const float ax = __ldg(src), ay = __ldg(src + 1), az = __ldg(src + 2);
#pragma unroll
  for (int j = 0; j < N; ++j)
    d[j] = d[j] == 0.0f ? sqdist(px[j], py[j], pz[j], ax, ay, az) : d[j];
  float bv;
  int bj;
  lane_argmax<N>(d, bv, bj);
  int cur = row_argmax(bv, (bj * kRowWarps + part) * 32 + lane, 0, xch);
  if (threadIdx.x == 0) orow[0] = cur;
  // from here d holds the running min distance to the picks: +inf before
  // the first, invalid -1, padding -inf (a min with a distance keeps both)
#pragma unroll
  for (int j = 0; j < N; ++j) d[j] = d[j] >= 0.0f ? INFINITY : d[j];

  // each step: the min with the last pick's distance, the lane's argmax,
  // the row's argmax
  for (int s = 1; s < k; ++s) {
    const float cx = __ldg(src + 3 * cur);
    const float cy = __ldg(src + 3 * cur + 1);
    const float cz = __ldg(src + 3 * cur + 2);
#pragma unroll
    for (int j = 0; j < N; ++j) d[j] = fminf(d[j], sqdist(px[j], py[j], pz[j], cx, cy, cz));
    lane_argmax<N>(d, bv, bj);
    cur = row_argmax(bv, (bj * kRowWarps + part) * 32 + lane, s, xch);
    if (threadIdx.x == 0) orow[s] = cur;
  }
}

// Run the picks over the slots up to the row's last valid one: exactly
// those up to 8, a power of two above (the header gives the times).
template <int SLOTS, int N>
__device__ __forceinline__ void row_dispatch(int jend, const float (&px)[SLOTS],
                                             const float (&py)[SLOTS], const float (&pz)[SLOTS],
                                             float (&d)[SLOTS], const float* __restrict__ src,
                                             int32_t* __restrict__ orow, int k,
                                             int2 (*xch)[kRowWarps]) {
  if constexpr (N > 8) {
    if (jend <= N / 2) {
      row_dispatch<SLOTS, N / 2>(jend, px, py, pz, d, src, orow, k, xch);
      return;
    }
  } else if constexpr (N > 1) {
    if (jend < N) {
      row_dispatch<SLOTS, N - 1>(jend, px, py, pz, d, src, orow, k, xch);
      return;
    }
  }
  row_picks<SLOTS, N>(px, py, pz, d, src, orow, k, xch);
}

// One CTA of kRowWarps warps per row, 32 * kRowWarps * SLOTS >= P.
template <int SLOTS>
__global__ void __launch_bounds__(32 * kRowWarps)
fps_warps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
                 int32_t* __restrict__ out, int P, int k) {
  __shared__ int2 xch[2][kRowWarps];
  __shared__ unsigned row_live;
  const int lane = threadIdx.x & 31;
  const int part = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const float* src = xyz + static_cast<size_t>(row) * P * 3;
  const uint8_t* vrow = valid + static_cast<size_t>(row) * P;
  int32_t* orow = out + static_cast<size_t>(row) * k;

  float px[SLOTS], py[SLOTS], pz[SLOTS], d[SLOTS];
  unsigned live = 0;  // slots with a valid candidate in some lane of this warp
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int p = (j * kRowWarps + part) * 32 + lane;
    const bool in = p < P;
    const bool v = in && vrow[p];
    d[j] = v ? 0.0f : (in ? -1.0f : -INFINITY);
    if (__any_sync(kFull, v)) live |= 1u << j;
  }
  if (threadIdx.x == 0) row_live = 0;
  __syncthreads();
  if (lane == 0 && live) atomicOr(&row_live, live);
  __syncthreads();
  live = row_live;  // slots with a valid candidate in some warp of the row
  if (!live) {  // no valid candidate: every pick is candidate 0, as argmax of all -1
    for (int s = threadIdx.x; s < k; s += 32 * kRowWarps) orow[s] = 0;
    return;
  }
  // slots from jend on hold only -1 and -inf and can win no step: the row's
  // warps leave them out alike, on one code path to their barriers
  const int jend = 32 - __clz(static_cast<int>(live));
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int p = (j * kRowWarps + part) * 32 + lane;
    const bool load = j < jend && p < P;
    px[j] = load ? src[3 * p] : 0.0f;
    py[j] = load ? src[3 * p + 1] : 0.0f;
    pz[j] = load ? src[3 * p + 2] : 0.0f;
  }
  row_dispatch<SLOTS, SLOTS>(jend, px, py, pz, d, src, orow, k, xch);
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
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oi = __shfl_down_sync(kFull, i, off);
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
      const float ov = __shfl_down_sync(kFull, v, off);
      const int oi = __shfl_down_sync(kFull, i, off);
      take_better(v, i, ov, oi);
    }
    if (lane == 0) *chosen = i;
  }
  __syncthreads();
  return *chosen;
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_block_rows_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
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

template <int SLOTS>
cudaError_t launch_warps(const float* xyz, const uint8_t* valid, int32_t* out, int B, int P,
                         int k, cudaStream_t stream) {
  fps_warps_kernel<SLOTS><<<B, 32 * kRowWarps, 0, stream>>>(xyz, valid, out, P, k);
  return cudaGetLastError();
}

template <int PPT>
cudaError_t launch_block_rows(const float* xyz, const uint8_t* valid, int32_t* out, int B, int P,
                              int k, cudaStream_t stream) {
  // the most shared memory any P of this instantiation asks, set once
  static const cudaError_t attr = cudaFuncSetAttribute(
      fps_block_rows_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(3 * PPT * kThreads * sizeof(float)));
  if (attr != cudaSuccess) return attr;
  const size_t smem = static_cast<size_t>(3) * P * sizeof(float);
  fps_block_rows_kernel<PPT><<<B, kThreads, smem, stream>>>(xyz, valid, out, P, k);
  return cudaGetLastError();
}

}  // namespace

// Largest candidate count per row the kernels take: the block design's
// (192 KB of shared memory).
extern "C" int seggroup_fps_max_points() { return 64 * kThreads; }

// xyz: (B, P, 3) f32 contiguous; valid: (B, P) bool (one byte each);
// out: (B, k) int32; warps: 1 for the warps design (P <= 4,096), 0 for the
// block design (4,096 < P <= 16,384); any other P is refused. Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 on
// success).
extern "C" int seggroup_masked_fps(const void* xyz, const void* valid, void* out,
                                   int B, int P, int k, int warps, int device,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B <= 0 || P <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(xyz);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (warps) {
    const int slots = (P + 32 * kRowWarps - 1) / (32 * kRowWarps);
    if (slots <= 1) e = launch_warps<1>(x, v, o, B, P, k, st);
    else if (slots <= 2) e = launch_warps<2>(x, v, o, B, P, k, st);
    else if (slots <= 4) e = launch_warps<4>(x, v, o, B, P, k, st);
    else if (slots <= 8) e = launch_warps<8>(x, v, o, B, P, k, st);
    else if (slots <= 16) e = launch_warps<16>(x, v, o, B, P, k, st);
    else if (slots <= 32) e = launch_warps<32>(x, v, o, B, P, k, st);
    else e = cudaErrorInvalidValue;
  } else {
    if (P <= 16 * kThreads) e = cudaErrorInvalidValue;  // the warps design's rows
    else if (P <= 32 * kThreads) e = launch_block_rows<32>(x, v, o, B, P, k, st);
    else if (P <= 64 * kThreads) e = launch_block_rows<64>(x, v, o, B, P, k, st);
    else e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
