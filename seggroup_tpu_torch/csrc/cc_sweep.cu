// One label-min sweep of the windowed radius-graph connected components on
// Hopper (kernel K4 of the port).
//
// Replaces the TPU kernel seggroup_tpu/ops/pallas_cc.py:_sweep_kernel
// (wrapper _sweep) and implements seggroup_tpu_torch/ops/radius_cc.py:sweep
// on the card; ops/cuda_cc.py builds and binds it, and
// radius_cc.sweep_plain is its plain PyTorch version.
//
// Semantics. The N rows are sorted by a (batch, cell) linear key and cut
// into tiles of T consecutive rows. For each tile and each of the 9 (dx, dy)
// column groups of the 27-cell stencil, radius_cc._prep gives the row range
// [lo, hi) that holds every candidate of the tile's rows. For query row i:
//
//   out[i] = min(label[i], min{ label[j] : j in one of the 9 ranges of i's
//                  tile, key[i] + off[g] - 1 <= key[j] <= key[i] + off[g] + 1,
//                  sem[j] == sem[i], |p_i - p_j|^2 <= r2 })
//
// Invalid rows carry class -3, key 2^30 and label N, so they match only one
// another and keep label N.
//
// Arithmetic order of the distance, and why. The Pallas body accumulates
// d2 = 0; d2 += dx*dx; d2 += dy*dy; d2 += dz*dz. Run as the JAX package's
// tests run it (interpret mode under jit on the CPU), XLA folds the zero and
// LLVM contracts the two adds into fma(dz, dz, fma(dx, dx, dy*dy)): on 120
// point pairs placed so that the candidate orders disagree about
// d2 <= r2, that form decided every edge as the reference did; the plain
// float32 sum ((dx*dx + dy*dy) + dz*dz) matched 70 of them and
// fma(dz, dz, fma(dy, dy, dx*dx)) 85. A pair at exactly the radius decides
// an edge and an edge a component, so the kernel writes this order with
// intrinsics (__fsub_rn, __fmul_rn, __fmaf_rn: nvcc's own contraction cannot
// change it) and sweep_plain emulates the same fused steps in float64
// (ops/fma.sqdist_fma). Kernel, plain version and reference agree bit for
// bit.
//
// From the Pallas kernel's operands to this kernel's:
//   slab (8, N+1024) f32 lane-major rows [x, y, z, sem, key_hi, key_lo,
//     label, 0]  ->  xyz (N, 3) f32, sem (N,) int32, key (N,) int32,
//     labels (N,) int32. The TPU's vector unit compares f32 only, hence
//     its labels and classes as f32 and the key as two exact f32 pieces
//     (key = hi * 4096 + lo) with a two-piece delta test; here the key
//     delta is one int32 subtraction (keys <= 2^30, |off| < 2^22).
//   win_base (N/256, 9) int32, 128-aligned, each the start of a fixed
//     1,024-row DMA  ->  lo, hi (N/T, 9) int32, the true range. A row
//     between the aligned base and lo, or from hi on, fails the key-delta
//     test for every valid query of the tile, so scanning [lo, hi) alone
//     gives the same minimum with less work; no padding rows are needed.
//   offs (9,) f32  ->  offs (9,) int32.  r2 (1,) f32  ->  r2, a pointer to
//     one float on the card (read here, so the host never waits for it).
//   out (1, N) f32  ->  out (N,) int32.
//   grid (N/256,), VMEM scratch (9, 8, 1024) f32, 9 DMA semaphores  ->  one
//     CTA of T threads per tile, each range staged through shared memory in
//     chunks of T rows (6 arrays of T words, 6 KB at T = 256).
//
// Design: thread t of CTA b owns query row b*T + t: its coordinates, class,
// key and running minimum stay in registers. For each range the CTA loads T
// rows at a time (one row per thread, coalesced), synchronises, and every
// thread walks the chunk: all threads read the same shared word, a
// broadcast. The integer key and class tests come first; the distance is
// formed only for rows that pass them.
//
// What bounds it on an H100 SXM: the function must read each row once (24 B:
// xyz, class, key, label) and write one label (4 B), and the two range
// tables: 7.4 MB at N = 262,144, 2.2 us at 3.35 TB/s. The operations the
// function needs are the pair tests that can pass the key test: for a valid
// query and a group, the rows of the range whose key lies in the query's
// 3-cell run key + off[g] - 1 .. key + off[g] + 1, at 8 f32 operations each
// (3 subtractions, 3 multiplications, 2 additions). On a bench scene at
// radius 0.03 that is 0.75 M pairs (7.4 per valid row) on a random-weight
// forward and 7.4 M (44.8 per valid row) on true labels: under 1 us at 67
// TFLOP/s, so the bytes set the bound, 2.2 us (chip_smoke.py computes both
// counts on each run). This design does much more than the function needs:
// every thread walks the tile's whole range of every group, 234 M and 384 M
// pairs on the same two problems (about 2,300 per valid row), rejecting
// nearly all on the integer key test. It takes 0.11 ms and 0.23 ms per sweep
// on an H100 at 700 W, 51 and 104 times the bound, limited by the
// shared-memory broadcast reads of the walk and by two barriers per chunk.
// The next step is to walk, per query, only its 3-cell key run (two binary
// searches in the sorted keys per group), which needs no staging at all.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void cc_sweep_kernel(const float* __restrict__ xyz,
                                const int32_t* __restrict__ sem,
                                const int32_t* __restrict__ key,
                                const int32_t* __restrict__ labels,
                                const int32_t* __restrict__ lo,
                                const int32_t* __restrict__ hi,
                                const int32_t* __restrict__ offs,
                                const float* __restrict__ r2_ptr,
                                int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int T = blockDim.x;
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + T;
  float* sz = sy + T;
  int32_t* ss = smem + 3 * T;
  int32_t* sk = ss + T;
  int32_t* sl = sk + T;

  const int tid = threadIdx.x;
  const int q = blockIdx.x * T + tid;
  const float qx = xyz[3 * q], qy = xyz[3 * q + 1], qz = xyz[3 * q + 2];
  const int32_t qs = sem[q];
  const int32_t qk = key[q];
  const float r2 = *r2_ptr;
  int32_t best = labels[q];

  for (int g = 0; g < 9; ++g) {
    const int begin = lo[blockIdx.x * 9 + g];
    const int end = hi[blockIdx.x * 9 + g];
    const int32_t kmin = qk + offs[g] - 1;
    const int32_t kmax = qk + offs[g] + 1;
    for (int c0 = begin; c0 < end; c0 += T) {
      const int r = c0 + tid;
      if (r < end) {
        sx[tid] = xyz[3 * r];
        sy[tid] = xyz[3 * r + 1];
        sz[tid] = xyz[3 * r + 2];
        ss[tid] = sem[r];
        sk[tid] = key[r];
        sl[tid] = labels[r];
      }
      __syncthreads();
      const int count = min(T, end - c0);
#pragma unroll 4
      for (int j = 0; j < count; ++j) {
        const int32_t kj = sk[j];
        if (kj >= kmin && kj <= kmax && ss[j] == qs) {
          const float dx = __fsub_rn(qx, sx[j]);
          const float dy = __fsub_rn(qy, sy[j]);
          const float dz = __fsub_rn(qz, sz[j]);
          const float d2 = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
          if (d2 <= r2) best = min(best, sl[j]);
        }
      }
      __syncthreads();
    }
  }
  out[q] = best;
}

}  // namespace

// xyz (N, 3) f32, sem/key/labels (N,) int32 in sorted order, lo/hi
// (N / tile, 9) int32, offs (9,) int32, r2 one f32 on the card, out (N,)
// int32; N a multiple of tile, tile a multiple of 32 and at most 1024. Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int seggroup_cc_sweep(const void* xyz, const void* sem, const void* key,
                                 const void* labels, const void* lo, const void* hi,
                                 const void* offs, const void* r2, void* out, int n,
                                 int tile, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n <= 0 || tile <= 0 || tile > 1024 || tile % 32 != 0 || n % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = static_cast<size_t>(6) * tile * sizeof(int32_t);
  cc_sweep_kernel<<<n / tile, tile, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int32_t*>(sem),
      static_cast<const int32_t*>(key), static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(offs), static_cast<const float*>(r2),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
