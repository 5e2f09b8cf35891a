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
//     delta is one int32 comparison (keys <= 2^30, |off| < 2^22).
//   win_base (N/256, 9) int32, 128-aligned, each the start of a fixed
//     1,024-row DMA  ->  lo, hi (N/T, 9) int32, the true range.
//   offs (9,) f32  ->  offs (9,) int32.  r2 (1,) f32  ->  r2, a pointer to
//     one float on the card (read here, so the host never waits for it).
//   out (1, N) f32  ->  out (N,) int32.
//   grid (N/256,), each step testing its 256 queries against every row of
//     its 9 DMA'd windows  ->  one thread per (query row, group), which
//     visits only the rows that can pass the key test.
//
// Design. The keys are sorted, so for query i and group g the rows of
// [lo, hi) whose key lies in key[i] + off[g] - 1 .. key[i] + off[g] + 1 form
// one contiguous run. A thread owns one (query, group) pair: it finds the
// run's two ends by two binary searches over key[lo, hi) (never the whole
// array: the intersection with the tile's range is what keeps the function
// that of the Pallas kernel for invalid query rows, for tiles where the
// valid rows end and for all-invalid tiles, whose hi lies below lo), their
// reads independent of each other, and walks the run with no branch in the
// loop (4 rows unrolled, their reads in flight together), testing class and
// distance there only. Two reads decide most empty runs before the search
// (the range's last key below the run, or its first above it). A CTA holds
// 9 warps over 32 consecutive query rows, warp g testing group g; the 9
// partial minima meet in shared memory and warp 0 writes the 32 labels.
// Splitting the groups across threads shortens the longest chain one
// thread walks (on a bench scene's doubled true labels one query's runs hold
// up to 314 rows, one (query, group)'s up to 46) and puts 9 times as many
// searches in flight.
//
// What bounds it on an H100 SXM: the function must read each row once (24 B:
// xyz, class, key, label) and write one label (4 B), and the two range
// tables: 7.4 MB at N = 262,144, 2.2 us at 3.35 TB/s. The operations the
// function needs are the pair tests that can pass the key test, the rows of
// the runs above, at 8 f32 operations each (3 subtractions, 3
// multiplications, 2 additions). On a bench scene at radius 0.03 that is
// 0.75 M pairs (7.4 per valid row) on a random-weight forward and 7.4 M
// (44.8 per valid row) on true labels: under 1 us at 67 TFLOP/s, so the
// bytes set the bound, 2.2 us. By construction this kernel tests only the
// rows of each (query, group)'s key run (radius_cc.key_runs gives them;
// tests/test_torch_radius_cc.py holds them to the rows that pass the key
// test): those the function needs, and the runs of invalid query rows,
// which hold no valid row. A design that walks every row of the tile's 9
// ranges for every query tests 234 M and 384 M pairs on the same two
// problems (chip_smoke.py prints both counts, taken from the keys).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, in turns against the
// previous design (a CTA per 256-row tile whose threads each walked the
// tile's 9 whole ranges), 50 launches queued behind a spin: 0.0202 ms a
// sweep on a full-width PointGroup forward's 262,144 rows (previously
// 0.1268) and 0.0366 ms on a bench scene's doubled true labels (previously
// 0.2262): 9 and 17 times the bound. The searches alone take 0.0157 and
// 0.0205 ms of that: their reads are the cost. One thread walking all 9
// groups of its query took 0.0240 and 0.0811 ms; one CTA per 256-row tile
// with each warp taking its group over the tile's 8 chunks in turn (the
// range's lines then hit L1) 0.0254 and 0.0524: fewer searches in flight
// cost more than the L2 reads they save. Keys staged in shared memory were
// slower in both layouts, and CTAs of 64 queries (18 warps) 4-9% slower
// than of 32. Where no row is valid it takes 0.0054 ms against the previous
// design's 0.0036 on 131,072 rows: nine threads a row, each with nothing to
// do.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kGroups = 9;
constexpr int kQ = 32;  // query rows of a CTA: one per lane

// The run [j0, j1) of key[begin, end) (begin < end) whose keys lie in
// [kmin, kmin + 2]: the last row below kmin and the last row at or below
// kmin + 2, each found by halving steps, the two reads of a step
// independent.
__device__ __forceinline__ void find_run(const int32_t* __restrict__ key, int begin, int end,
                                         int32_t kmin, int& j0, int& j1) {
  const int32_t kmax = kmin + 2;
  int a = begin - 1, b = begin - 1;
  for (int step = 1 << (31 - __clz(end - begin)); step > 0; step >>= 1) {
    if (a + step < end && key[a + step] < kmin) a += step;
    if (b + step < end && key[b + step] <= kmax) b += step;
  }
  j0 = a + 1;
  j1 = b + 1;
}

// The least label of the rows [j0, j1) of class qs within r2 of (qx, qy,
// qz), INT_MAX if none; no branch in the loop, so the reads of several rows
// are in flight together.
__device__ __forceinline__ int32_t walk(const float* __restrict__ xyz,
                                        const int32_t* __restrict__ sem,
                                        const int32_t* __restrict__ labels, int j0, int j1,
                                        float qx, float qy, float qz, int32_t qs, float r2) {
  int32_t m = INT_MAX;
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const float dx = __fsub_rn(qx, xyz[3 * j]);
    const float dy = __fsub_rn(qy, xyz[3 * j + 1]);
    const float dz = __fsub_rn(qz, xyz[3 * j + 2]);
    const float d2 = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
    const int32_t lj = labels[j];
    m = (sem[j] == qs && d2 <= r2) ? min(m, lj) : m;
  }
  return m;
}

// CTA: 9 warps over kQ consecutive query rows; warp g tests group g.
__global__ void __launch_bounds__(kQ * kGroups)
cc_sweep_kernel(const float* __restrict__ xyz, const int32_t* __restrict__ sem,
                const int32_t* __restrict__ key, const int32_t* __restrict__ labels,
                const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                const int32_t* __restrict__ offs, const float* __restrict__ r2_ptr,
                int32_t* __restrict__ out, int tile) {
  __shared__ int32_t part[kGroups][kQ];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int q = blockIdx.x * kQ + lane;
  const int t = q / tile;
  const int begin = lo[t * kGroups + g];
  const int end = hi[t * kGroups + g];
  int32_t m = INT_MAX;
  if (begin < end) {
    const int32_t kmin = key[q] + offs[g] - 1;
    if (key[end - 1] >= kmin && key[begin] <= kmin + 2) {
      int j0, j1;
      find_run(key, begin, end, kmin, j0, j1);
      m = walk(xyz, sem, labels, j0, j1, xyz[3 * q], xyz[3 * q + 1], xyz[3 * q + 2], sem[q],
               *r2_ptr);
    }
  }
  part[g][lane] = m;
  __syncthreads();
  if (g == 0) {
    int32_t best = labels[q];
#pragma unroll
    for (int h = 0; h < kGroups; ++h) best = min(best, part[h][lane]);
    out[q] = best;
  }
}

}  // namespace

// xyz (N, 3) f32, sem/key/labels (N,) int32 in sorted order, lo/hi
// (N / tile, 9) int32, offs (9,) int32, r2 one f32 on the card, out (N,)
// int32; N a multiple of tile and tile a multiple of 32, so that N is a
// multiple of the 32 query rows a CTA takes.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success).
extern "C" int seggroup_cc_sweep(const void* xyz, const void* sem, const void* key,
                                 const void* labels, const void* lo, const void* hi,
                                 const void* offs, const void* r2, void* out, int n,
                                 int tile, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n <= 0 || tile <= 0 || tile % 32 != 0 || n % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cc_sweep_kernel<<<n / kQ, kQ * kGroups, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int32_t*>(sem),
      static_cast<const int32_t*>(key), static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(offs), static_cast<const float*>(r2),
      static_cast<int32_t*>(out), tile);
  return static_cast<int>(cudaGetLastError());
}
