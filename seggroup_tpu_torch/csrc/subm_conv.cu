// Kernel K2: the forward of the submanifold sparse convolution, a gather-GEMM
// over a plain (M, K) rulebook, hand-written for Hopper (sm_90a). The same
// kernel computes the data gradient (flipped, transposed weights over the
// same rulebook).
//
//   out[i, :] = sum_k sum_c feats[nbr[i, k], c] * W[k, c, :]
//
// feats (M, Cin) bf16, W (K, Cin, Cout) bf16, rulebook (M, K) int32 with any
// value outside [0, M) (the engine writes M) marking an absent neighbour;
// out (M, Cout) float32, the sum accumulated in float32. Cin and Cout are
// multiples of 8 (the wrapper pads the features with zeros; the weights'
// padding is written by the first pass). M and Cout need not be multiples
// of the tiles.
//
// Replaces the three forward Pallas kernels of
// seggroup_tpu/sparse/pallas_conv.py, which compute the same function over a
// windowed plan of the rulebook:
//   _fwd_kernel         (pallas_conv.py:72,  K2a, full-width one-hot gather)
//   _fwd_kernel_chunked (pallas_conv.py:158, K2b, chunked one-hot, Cin > 64)
//   _fwd_kernel_packed  (pallas_conv.py:343, K2c, lane-packed, Cin <= 64)
// The window plan, the one-hot gather and the lane packing work around the
// TPU's slow row gathers; here each CTA gathers its rows straight from the
// rulebook. The entry points are named after the Pallas variant each
// channel regime replaces (subm_conv_k2c_shift2 Cin <= 32,
// subm_conv_k2c_shift1 Cin <= 64, subm_conv_k2ab_chunked Cin > 64); one
// design serves all three.
//
// Design, two passes, the second launched to start under the first
// (programmatic dependent launch: its prologue and its first gathers do not
// read Wt, and it waits for the first pass before it does):
//  1. subm_conv_weights_k_major: W (K, Cin, Cout), any strides (the data
//     gradient's transposed view is read in place), into the K-major
//     (Cout_p, K * Cin_p) matrix Wt, zero in the padding: a 32 x 32 tile
//     transpose through shared memory. Not where the wrapper's plan is
//     direct (K = 1 with N <= 64; it then passes no Wt): there the second
//     pass reads W itself, a value at a time, and transposes it in
//     registers, in instantiations of their own so that the others keep
//     their registers. The card takes 1-2 us more for that from Cin = 64
//     up, but the call makes one launch instead of two, and at K = 1 the
//     host's time per call, not the card's, sets the time.
//  2. subm_gather_gemm: a CTA owns 128 output rows and an N tile of Cout:
//     the whole Cout up to 256 (N = Cout rounded up to one of 16, 32, ...,
//     112, 128, 192, 256), equal tiles above it, and half of it where the
//     row tiles alone would not fill the card (the bench scene's level 3).
//     A feature row is gathered once per present offset and N tile.
//     - Prologue: the tile's 128 x K rulebook block is read once, coalesced
//       (it is contiguous), into shared memory, and the tile's present
//       offsets (those with a row in [0, M)) are listed in ascending k, for
//       any K (the block and the list are sized by K at launch).
//     - Reduction axis: the flattened sequence of (present offset, 8-channel
//       piece), cut into stages of 64 values (8 pieces). At Cin <= 32 one
//       stage packs 2-8 offsets; at Cin = 80 a stage crosses an offset
//       boundary, so Cin > 64 needs no chunked shape of its own. A tile
//       with no present offset has no stage and writes zeros.
//     - Ring: up to 4 stages in dynamic shared memory (3 where two CTAs
//       then share an SM or a large K's rulebook block leaves no room; as
//       many as a tile can have where that is fewer, K = 1). 16-byte
//       cp.async.cg copies write A (128 rows x 64 values of the gathered
//       features; src size 0, zeros, for an absent neighbour and past the
//       last piece) and B (N rows x the same 64 values of Wt) in wgmma's
//       K-major layout with the 128-byte swizzle (8-row atoms of 128-byte
//       rows, the 16-byte pieces of row r permuted by r % 8). Both operands
//       K-major: every N that is a multiple of 8 has the one layout, where
//       an MN-major B would need a swizzle per N.
//     - Products: per warpgroup one wgmma m64nNk16 per k16 step on its 64
//       rows, float32 sums in registers (N / 2 a thread), one
//       fence.proxy.async per stage, one wgmma group kept in flight across
//       a stage (wgmma.wait_group 1).
//     - Two forms. N <= 128: 256 threads that all copy and multiply, a
//       barrier per stage, S - 2 stages of copies ahead.
//       subm_gather_gemm_ws (N = 192, 256): warpgroup 0 copies and
//       warpgroups 1-2 multiply, each stage handed over by a full and an
//       empty mbarrier (cp.async.mbarrier.arrive), no CTA-wide barrier.
//     - Epilogue: the float32 tile from the registers to out, masked on the
//       ragged M and Cout edges.
//     No atomics, no workspace: a CTA sums its offsets in a fixed order, so
//     the result is bit-identical from run to run.
// Each choice of the plan was timed on both sides on one card (NVIDIA H100
// 80GB HBM3, 700.00 W; device ms; PERF.md): the warp-specialised form
// against the plain one at N = 256 1.8692 against 2.0374 at (384, 256),
// at N = 192 2.2422 against 2.3720 (the data gradient's (256, 384)), at
// N = 128 0.4046 plain against 0.5452 at (128, 128); 3 stages against 4
// at N = 80-128 on grids of more than two CTAs an SM: 0.4046 against
// 0.5543 at (128, 128), 0.1201 against 0.1676 at PointGroup's (80, 80);
// N halved at the bench scene's level 3 (5,642 valid rows of 16,384):
// 0.1944 against 0.2418 at (384, 256), though on 16,384 rows that are all
// valid the whole N is faster (0.0882 against 0.1357 at (128, 256)).
// mma.sync m16n8k16 reading the same swizzled stages through ldmatrix
// was 1-42% slower than wgmma at every pair with Cout <= 32 (0.1106
// against 0.1005 at (32, 32)) and 20-100% slower at wider ones, so every
// regime runs on wgmma.
//
// Bound. The function must read the bf16 features (M*Cin*2 bytes), the
// rulebook (M*K*4), the weights (K*Cin*Cout*2) and write the f32 output
// (M*Cout*4), at 3.35 TB/s; it does 2*Cin*Cout operations per present
// (row, offset) pair, at 989 TFLOP/s of bf16. This design multiplies every
// row of a tile by every present offset of the tile (26.7 of 27 at the
// dense sites, where a row has 13.5; 27.0 at the bench scene's level 0,
// where a row has 3.76), and moves (128 * Cin + Cin * N) * 2 bytes per
// present offset and tile into each SM.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W against the previous
// design (a WMMA kernel of 64 x 32-128 tiles), in turns, device times
// (launches queued behind a spin; PERF.md): (384, 256) on 131,072 dense
// sites 1.8680 ms against 4.7788, with the pre-gathered matmul at 1.00
// (bound 0.35, operations); (32, 64) 0.1122 against 0.2355, (64, 128)
// 0.2260 against 0.4811, PointGroup's (80, 80) 0.1202 against 0.3395;
// every pair of Res16UNet34C, its data gradient and PointGroup 1.14 to
// 3.0 times faster, but PointGroup's K = 1 (64, 32), as fast (0.0095; the
// direct form). Timed a call back to back, the host's time included, most
// of PointGroup's K = 1 pairs take 8-20% longer than before (one or two
// launches and the wrapper's work a call, where the card takes 5-26 us).
// What sets the time at (384, 256), 1.8675 ms: without its products the
// kernel takes 1.4397 ms, without its copies 1.2152, without the A
// gathers 1.5433, without the B copies 1.7049. Copies and products each
// take more than the matmul, overlap at 70% of their sum, and the
// products are twice the present pairs.
//
// What is left undone: reordering rows so that a tile shares its present
// offsets (the products of absent pairs inside present offsets: half the
// work at the dense sites, six sevenths at level 0), a gather that feeds
// wgmma without a barrier per stage at N <= 128, the weights pass on every
// call (a conv's weights change once a step), the host's time per call
// (at PointGroup's K = 1 pairs the card takes less time than the wrapper's
// launch, so calls back to back wait on the host), and halving N from the
// valid rows (on the card) rather than from the capacity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;               // output rows per CTA
constexpr int THREADS = 256;          // two warpgroups
constexpr int BK = 64;                // reduction values per stage
constexpr int PIECES = BK / 8;        // 16-byte pieces per stage row
constexpr int A_BYTES = BM * BK * 2;  // 16 KB
constexpr int SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; src_bytes = 0 writes
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n groups of this thread's copies are pending (n < 4)
__device__ __forceinline__ void cp_async_wait(int n) {
    if (n >= 3)
        asm volatile("cp.async.wait_group 3;\n" ::);
    else if (n == 2)
        asm volatile("cp.async.wait_group 2;\n" ::);
    else if (n == 1)
        asm volatile("cp.async.wait_group 1;\n" ::);
    else
        asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving the accumulator's reads and writes across
// the wgmma fences and waits: wgmma writes it after the instruction issues
__device__ __forceinline__ void fence_operand(float& r) {
    asm volatile("" : "+f"(r)::"memory");
}

// the copies that cp.async wrote (generic proxy) become visible to wgmma's
// reads (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Programmatic dependent launch: the weights pass lets the gather-GEMM
// start (its prologue reads only the rulebook), and the gather-GEMM waits
// for the weights pass to finish before it reads Wt.
__device__ __forceinline__ void launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prerequisites() {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// mbarriers, for the warp-specialised kernel
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// an arrival on the barrier once this thread's earlier cp.async copies have
// landed (the barrier's count includes it)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of the given parity has completed; a wait that lasts
// seconds traps (a launch error) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    for (long long spins = 0;; ++spins) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (done) return;
        if (spins > (1ll << 26)) __trap();
    }
}

// Byte offset of 16-byte piece j (values 8j .. 8j + 7) of row r in a stage:
// wgmma's K-major layout with the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int r, int j) {
    return (r >> 3) * 1024 + (r & 7) * 128 + ((j ^ (r & 7)) << 4);
}

// A wgmma shared-memory descriptor for a K-major operand with the 128-byte
// swizzle: start address, leading byte offset (unused by this layout: 1),
// stride byte offset 1,024 (between 8-row atoms), in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
           static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

// d += one k16 step of a warpgroup's 64 x N tile, m64nNk16: bf16 operands,
// float32 sums, both operands K-major in 128-byte-swizzled shared memory
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b);

#define R8_0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define R8_1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define R8_2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define R8_3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define R8_4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define R8_5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define R8_6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define R8_7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define R8_8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define R8_9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define R8_10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define R8_11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define R8_12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define R8_13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define R8_14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define R8_15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define F8(i)                                                                              \
    "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
        "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
// N: the instruction's width; DA, DB, SC: the operand numbers of the two
// descriptors and of the scale flag (after the N / 2 sums); REGS: the sums'
// operand list; the rest: their constraints
#define WGMMA_K_MAJOR(N, DA, DB, SC, REGS, ...)                                         \
    template <>                                                                         \
    __device__ __forceinline__ void wgmma<N>(float (&d)[N / 2], uint64_t desc_a,        \
                                             uint64_t desc_b) {                         \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"                  \
                     "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS \
                     "}, %" #DA ", %" #DB ", p, 1, 1, 0, 0;\n}\n"                       \
                     : __VA_ARGS__                                                      \
                     : "l"(desc_a), "l"(desc_b), "r"(1));                               \
    }

WGMMA_K_MAJOR(16, 8, 9, 10, R8_0, F8(0))
WGMMA_K_MAJOR(32, 16, 17, 18, R8_0 ", " R8_1, F8(0), F8(8))
WGMMA_K_MAJOR(48, 24, 25, 26, R8_0 ", " R8_1 ", " R8_2, F8(0), F8(8), F8(16))
WGMMA_K_MAJOR(64, 32, 33, 34, R8_0 ", " R8_1 ", " R8_2 ", " R8_3, F8(0), F8(8), F8(16), F8(24))
WGMMA_K_MAJOR(80, 40, 41, 42, R8_0 ", " R8_1 ", " R8_2 ", " R8_3 ", " R8_4, F8(0), F8(8),
              F8(16), F8(24), F8(32))
WGMMA_K_MAJOR(96, 48, 49, 50, R8_0 ", " R8_1 ", " R8_2 ", " R8_3 ", " R8_4 ", " R8_5, F8(0),
              F8(8), F8(16), F8(24), F8(32), F8(40))
WGMMA_K_MAJOR(112, 56, 57, 58,
              R8_0 ", " R8_1 ", " R8_2 ", " R8_3 ", " R8_4 ", " R8_5 ", " R8_6, F8(0), F8(8),
              F8(16), F8(24), F8(32), F8(40), F8(48))
WGMMA_K_MAJOR(128, 64, 65, 66,
              R8_0 ", " R8_1 ", " R8_2 ", " R8_3 ", " R8_4 ", " R8_5 ", " R8_6 ", " R8_7,
              F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56))
WGMMA_K_MAJOR(192, 96, 97, 98,
              R8_0 ", " R8_1 ", " R8_2 ", " R8_3 ", " R8_4 ", " R8_5 ", " R8_6 ", " R8_7
                   ", " R8_8 ", " R8_9 ", " R8_10 ", " R8_11,
              F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72),
              F8(80), F8(88))
WGMMA_K_MAJOR(256, 128, 129, 130,
              R8_0 ", " R8_1 ", " R8_2 ", " R8_3 ", " R8_4 ", " R8_5 ", " R8_6 ", " R8_7
                   ", " R8_8 ", " R8_9 ", " R8_10 ", " R8_11 ", " R8_12 ", " R8_13 ", " R8_14
                       ", " R8_15,
              F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72),
              F8(80), F8(88), F8(96), F8(104), F8(112), F8(120))

// the float32 sums (v0, v1) of row `row` at columns n, n + 1, where they lie
// inside (m, cout)
__device__ __forceinline__ void store2(float* out, int row, int n, int m, int cout, float v0,
                                       float v1) {
    if (row < m && n < cout)
        *reinterpret_cast<float2*>(out + (size_t)row * cout + n) = make_float2(v0, v1);
}

// The products through wgmma: warpgroup g multiplies rows 64 g .. 64 g + 63
// of the A stage by the whole B stage.
template <int N_>
struct WgmmaMath {
    static constexpr int N = N_;

    float acc[N / 2];
    int wg;

    __device__ explicit WgmmaMath(int warpgroup) {
        wg = warpgroup;
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
    }

    // the four k16 steps of a stage, issued as one group
    __device__ void issue(uint32_t a_stage, uint32_t b_stage) {
#pragma unroll
        for (int e = 0; e < N / 2; ++e) fence_operand(acc[e]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
            wgmma<N>(acc, wgmma_desc(a_stage + wg * 8 * 1024 + ks * 32),
                     wgmma_desc(b_stage + ks * 32));
        wgmma_commit();
    }

    // until at most PENDING groups run
    template <int PENDING>
    __device__ void wait() {
        wgmma_wait<PENDING>();
#pragma unroll
        for (int e = 0; e < N / 2; ++e) fence_operand(acc[e]);
    }

    // warp w of the warpgroup holds rows 16 w .. 16 w + 15, laid out in each
    // n8 block as mma.sync's C fragment
    __device__ void store(float* out, int m0, int n0, int m, int cout) const {
        const int lane = threadIdx.x % 32;
        const int row = m0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            const int n = n0 + j * 8 + (lane % 4) * 2;
            store2(out, row, n, m, cout, acc[4 * j], acc[4 * j + 1]);
            store2(out, row + 8, n, m, cout, acc[4 * j + 2], acc[4 * j + 3]);
        }
    }
};

// Dynamic shared memory of a CTA: the ring (1,024-aligned), the rulebook
// block, the present-offset list and the offset flags
// (sparse/cuda_subm_conv.py:smem_bytes computes the same).
__host__ __device__ constexpr int ring_stage_bytes(int n) { return A_BYTES + n * BK * 2; }

constexpr int MBAR_BYTES = 64;  // a full and an empty barrier per stage, up to 4 stages

__host__ __device__ constexpr int smem_bytes(int n, int kvol, int stages) {
    return 1024 + stages * ring_stage_bytes(n) + MBAR_BYTES + (BM * kvol + 2 * kvol + 4) * 4;
}

// Pass 1: Wt[n, k * cin_p + c] = W[k, c, n] inside (cin, cout), 0 in the
// padding; W read through its strides. A 32 x 32 tile per CTA of 32 x 8
// threads, read along W's unit-stride dimension.
__global__ void subm_conv_weights_k_major(const __nv_bfloat16* __restrict__ w,
                                          __nv_bfloat16* __restrict__ wt, int kvol, int cin,
                                          int cout, int cin_p, int cout_p, long long sk,
                                          long long sc, long long sn) {
    __shared__ __nv_bfloat16 tile[32][33];  // [kc - kc0][n - n0]
    launch_dependents();
    const int kc0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int kcs = kvol * cin_p;
    const bool n_fast = sn == 1;
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int a = ty + 8 * i;
        const int kl = n_fast ? a : tx, nl = n_fast ? tx : a;
        const int kc = kc0 + kl, n = n0 + nl;
        const int k = kc / cin_p, c = kc - k * cin_p;
        __nv_bfloat16 v = zero;
        if (kc < kcs && c < cin && n < cout) v = w[k * sk + c * sc + n * sn];
        tile[kl][nl] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = n0 + ty + 8 * i, kc = kc0 + tx;
        if (n < cout_p && kc < kcs) wt[(size_t)n * kcs + kc] = tile[tx][ty + 8 * i];
    }
}

// The shared memory of a CTA after the aligned ring: its barriers, the
// rulebook block, the present-offset list and the offset flags.
struct Shared {
    uint32_t ring, full_bar, empty_bar;
    int *rb, *plist, *flag, *npresent;

    __device__ Shared(unsigned char* smem, int stage_bytes, int stages, int kvol) {
        ring = (smem_addr(smem) + 1023) & ~1023u;
        full_bar = ring + stages * stage_bytes;  // per stage: its copies have landed
        empty_bar = full_bar + 32;               // per stage: its products are done
        rb = reinterpret_cast<int*>(smem + (ring - smem_addr(smem)) + stages * stage_bytes +
                                    MBAR_BYTES);
        plist = rb + BM * kvol;
        flag = plist + kvol;
        npresent = flag + kvol;
    }
};

// Prologue of a CTA: the rulebook block of rows m0 .. m0 + 127 (contiguous)
// into shared memory, absent entries as -1, and the tile's present offsets
// in ascending k. Returns the number of stages.
template <int T>
__device__ int prologue(const Shared& sh, const int32_t* __restrict__ rulebook, int m, int m0,
                        int kvol, int cin) {
    const int tid = threadIdx.x;
    const int rows = min(BM, m - m0);
    for (int k = tid; k < kvol; k += T) sh.flag[k] = 0;
    __syncthreads();
    const int32_t* rb_g = rulebook + (size_t)m0 * kvol;
#pragma unroll 4
    for (int e = tid; e < BM * kvol; e += T) {
        const int j = e < rows * kvol ? rb_g[e] : -1;
        const bool on = j >= 0 && j < m;
        sh.rb[e] = on ? j : -1;
        if (on) sh.flag[e % kvol] = 1;
    }
    __syncthreads();
    if (tid < 32) {
        int count = 0;
        for (int k0 = 0; k0 < kvol; k0 += 32) {
            const int k = k0 + tid;
            const bool on = k < kvol && sh.flag[k];
            const unsigned ballot = __ballot_sync(0xffffffffu, on);
            if (on) sh.plist[count + __popc(ballot & ((1u << tid) - 1u))] = k;
            count += __popc(ballot);
        }
        if (tid == 0) *sh.npresent = count;
    }
    __syncthreads();
    return (*sh.npresent * (cin / 8) + PIECES - 1) / PIECES;
}

// B's source where there is no Wt (K = 1, no weights pass): W (1, Cin,
// Cout) through its strides, read a value at a time and transposed in
// registers (the weights of one offset are a few KB).
struct DirectWeights {
    const __nv_bfloat16* w;
    long long sc, sn;  // W's strides along Cin and Cout
    int cin, cout;     // W's own widths (not padded)
};

// The 16-byte copies of stage t that one thread makes: piece j of A rows
// r0 + step * u (copy_a) and of B rows r0 + step * u (copy_b), zeros for an
// absent neighbour, past the last piece and past Cout; B from Wt, or from W
// itself where DIRECT.
template <int N, int STEP, bool DIRECT>
__device__ __forceinline__ void copy_stage(const Shared& sh, uint32_t a_st, int t, int j, int r0,
                                           const __nv_bfloat16* __restrict__ feats,
                                           const __nv_bfloat16* __restrict__ wt,
                                           const DirectWeights& wd, int n0, int cin, int cout,
                                           int kvol, bool copy_a, bool copy_b) {
    const uint32_t b_st = a_st + A_BYTES;
    const int per_offset = cin / 8;
    const int q = t * PIECES + j;
    const bool live = q < *sh.npresent * per_offset;
    int k = 0, c = 0;
    if (live) {
        const int p = q / per_offset;
        c = q - p * per_offset;
        k = sh.plist[p];
    }
    const int* nbr = sh.rb + k;
#pragma unroll
    for (int u = 0; u < BM / STEP; ++u) {
        const int r = r0 + STEP * u;
        const int nb = live ? nbr[r * kvol] : -1;
        if (copy_a)
            cp_async16(a_st + swz(r, j), nb >= 0 ? feats + (size_t)nb * cin + c * 8 : feats,
                       nb >= 0 ? 16 : 0);
    }
    if (!copy_b) return;
    if constexpr (DIRECT) {
#pragma unroll
        for (int u = 0; u < (N + STEP - 1) / STEP; ++u) {
            const int n = r0 + STEP * u;
            if (n >= N) continue;
            __align__(16) __nv_bfloat16 v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int ci = c * 8 + e;
                const bool on = live && ci < wd.cin && n0 + n < wd.cout;
                v[e] = on ? wd.w[ci * wd.sc + (n0 + n) * wd.sn] : __float2bfloat16(0.0f);
            }
            const uint4 packed = *reinterpret_cast<const uint4*>(v);
            asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(b_st + swz(n, j)),
                         "r"(packed.x), "r"(packed.y), "r"(packed.z), "r"(packed.w)
                         : "memory");
        }
        return;
    }
    const __nv_bfloat16* wk = wt + (size_t)k * cin + c * 8;
    const size_t kcs = (size_t)kvol * cin;  // the length of a Wt row
#pragma unroll
    for (int u = 0; u < (N + STEP - 1) / STEP; ++u) {
        const int n = r0 + STEP * u;
        if (n < N) {
            const bool on = live && n0 + n < cout;
            cp_async16(b_st + swz(n, j), on ? wk + (n0 + n) * kcs : wt, on ? 16 : 0);
        }
    }
}

// Pass 2: one CTA of two warpgroups per (128-row tile, N tile). Every thread
// copies and both warpgroups multiply; a barrier per stage. DIRECT: B from
// W itself (K = 1).
template <class M, bool DIRECT>
__global__ void __launch_bounds__(THREADS, 1)
subm_gather_gemm(const __nv_bfloat16* __restrict__ feats, const __nv_bfloat16* __restrict__ wt,
                 const DirectWeights wd, const int32_t* __restrict__ rulebook,
                 float* __restrict__ out, int m, int cin, int cout, int kvol, int stages) {
    constexpr int N = M::N;
    constexpr int STAGE = ring_stage_bytes(N);
    extern __shared__ __align__(16) unsigned char smem[];
    const Shared sh(smem, STAGE, stages, kvol);
    const int tid = threadIdx.x;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * N;
    // launched to start under the kernel before it: without a weights pass
    // (DIRECT) that kernel may be the one that wrote feats and the rulebook
    if constexpr (DIRECT) wait_prerequisites();
    const int nst = prologue<THREADS>(sh, rulebook, m, m0, kvol, cin);
    // stages of copies in flight: all of them where the ring holds them,
    // else the ring less the stage being multiplied and the one whose
    // products may still run
    const int ahead = nst <= stages ? nst : stages - 2;
    const int j = tid % PIECES, r0 = tid / PIECES;
    auto copy = [&](int t, bool a, bool b) {
        copy_stage<N, THREADS / PIECES, DIRECT>(sh, sh.ring + (t % stages) * STAGE, t, j, r0, feats, wt,
                                        wd, n0, cin, cout, kvol, a, b);
    };

    M math(tid / 128);
    // the first stages' gathers go out while the weights pass may still
    // run; their weights after it (copy group 0 holds those gathers too)
    for (int t = 0; t < ahead && t < nst; ++t) copy(t, true, false);
    if constexpr (!DIRECT) wait_prerequisites();  // Wt is written
    for (int t = 0; t < ahead; ++t) {
        if (t < nst) copy(t, false, true);
        cp_async_commit();
    }
    for (int s = 0; s < nst; ++s) {
        // stage s has landed for this thread; after the barrier for every
        // thread, and every warpgroup has waited for the products of stage
        // s - 2, whose slot the next copies reuse
        cp_async_wait(ahead - 1);
        fence_proxy_async();
        __syncthreads();
        const uint32_t a_st = sh.ring + (s % stages) * STAGE;
        math.issue(a_st, a_st + A_BYTES);  // the tensor cores start at once
        if (s + ahead < nst) copy(s + ahead, true, true);
        cp_async_commit();
        math.template wait<1>();  // stage s - 1's products are done
    }
    math.template wait<0>();
    cp_async_wait(0);
    math.store(out, m0, n0, m, cout);
}

// Pass 2, warp-specialised: warpgroup 0 copies, warpgroups 1 and 2
// multiply; full and empty barriers per stage instead of a CTA-wide barrier.
constexpr int WS_THREADS = 384;

template <class M>
__global__ void __launch_bounds__(WS_THREADS, 1)
subm_gather_gemm_ws(const __nv_bfloat16* __restrict__ feats,
                    const __nv_bfloat16* __restrict__ wt, const DirectWeights wd,
                    const int32_t* __restrict__ rulebook, float* __restrict__ out, int m,
                    int cin, int cout, int kvol, int stages) {
    constexpr int N = M::N;
    constexpr int STAGE = ring_stage_bytes(N);
    extern __shared__ __align__(16) unsigned char smem[];
    const Shared sh(smem, STAGE, stages, kvol);
    const int tid = threadIdx.x;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * N;
    if (tid == 0) {
        for (int t = 0; t < stages; ++t) {
            mbar_init(sh.full_bar + 8 * t, 128);  // one arrival per copying thread
            mbar_init(sh.empty_bar + 8 * t, 8);   // one per multiplying warp
        }
    }
    const int nst = prologue<WS_THREADS>(sh, rulebook, m, m0, kvol, cin);
    wait_prerequisites();  // Wt is written

    if (tid < 128) {  // the copies
        const int j = tid % PIECES, r0 = tid / PIECES;
        for (int t = 0; t < nst; ++t) {
            const int slot = t % stages;
            if (t >= stages) mbar_wait(sh.empty_bar + 8 * slot, ((t / stages) + 1) & 1);
            copy_stage<N, 128 / PIECES, false>(sh, sh.ring + slot * STAGE, t, j, r0, feats, wt, wd, n0,
                                        cin, cout, kvol, true, true);
            cp_async_mbar_arrive(sh.full_bar + 8 * slot);
        }
        cp_async_wait(0);
        return;
    }
    M math(tid / 128 - 1);
    for (int s = 0; s < nst; ++s) {
        const int slot = s % stages;
        mbar_wait(sh.full_bar + 8 * slot, (s / stages) & 1);
        fence_proxy_async();
        const uint32_t a_st = sh.ring + slot * STAGE;
        math.issue(a_st, a_st + A_BYTES);
        math.template wait<1>();  // stage s - 1's products are done: release it
        if (s > 0 && tid % 32 == 0) mbar_arrive(sh.empty_bar + 8 * ((s - 1) % stages));
    }
    math.template wait<0>();
    math.store(out, m0, n0, m, cout);
}

// the kernel of N tile M, warp-specialised or not, B from W or Wt (only
// the one asked for is instantiated)
template <class M, bool WS, bool DIRECT>
auto kernel_of() {
    if constexpr (WS)
        return subm_gather_gemm_ws<M>;
    else
        return subm_gather_gemm<M, DIRECT>;
}

template <class M, bool WS, bool DIRECT>
cudaError_t launch(const __nv_bfloat16* feats, const __nv_bfloat16* wt, const DirectWeights& wd,
                   const int32_t* rulebook, float* out, int m, int cin, int cout, int kvol,
                   int n_tiles, int stages, cudaStream_t stream) {
    const auto kernel = kernel_of<M, WS, DIRECT>();
    // above 48 KB of dynamic shared memory a kernel must ask for it, once
    static cudaError_t raised =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (raised != cudaSuccess) return raised;
    const int smem = smem_bytes(M::N, kvol, stages);
    // a ring of fewer than 3 stages only where it holds every stage the tile
    // can have (the plain kernel), and of 2 at least (the warp-specialised)
    const int most = (kvol * (cin / 8) + PIECES - 1) / PIECES;
    const bool ring_ok = WS ? stages >= 2 : stages >= 3 || stages >= most;
    if (!ring_ok || stages > 4 || smem > SMEM_LIMIT || n_tiles * M::N < cout)
        return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((m + BM - 1) / BM, n_tiles);
    cfg.blockDim = dim3(WS ? WS_THREADS : THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, feats, wt, wd, rulebook, out, m, cin, cout, kvol,
                              stages);
}

// the instantiation of N tile width n (sparse/cuda_subm_conv.py:N_TILES), on
// the warp-specialised kernel or not, B from W itself (wd.w set) or Wt
cudaError_t launch_n(const __nv_bfloat16* feats, const __nv_bfloat16* wt,
                     const DirectWeights& wd, const int32_t* rulebook, float* out, int m, int cin,
                     int cout, int kvol, int n, int n_tiles, int stages, int ws,
                     cudaStream_t stream) {
    const bool direct = wd.w != nullptr;
#define SUBM_CONV_N(W, S, D)                                                                   \
    if (n == W && ws == S && direct == D)                                                      \
        return launch<WgmmaMath<W>, S, D>(feats, wt, wd, rulebook, out, m, cin, cout, kvol,    \
                                          n_tiles, stages, stream);
    SUBM_CONV_N(16, 0, false)
    SUBM_CONV_N(32, 0, false)
    SUBM_CONV_N(48, 0, false)
    SUBM_CONV_N(64, 0, false)
    SUBM_CONV_N(80, 0, false)
    SUBM_CONV_N(96, 0, false)
    SUBM_CONV_N(112, 0, false)
    SUBM_CONV_N(128, 0, false)
    SUBM_CONV_N(192, 0, false)
    SUBM_CONV_N(256, 0, false)
    SUBM_CONV_N(192, 1, false)
    SUBM_CONV_N(256, 1, false)
    SUBM_CONV_N(16, 0, true)
    SUBM_CONV_N(32, 0, true)
    SUBM_CONV_N(48, 0, true)
    SUBM_CONV_N(64, 0, true)
#undef SUBM_CONV_N
    return cudaErrorInvalidValue;
}

cudaError_t launch_weights(const void* w, void* wt, int kvol, int cin, int cout, int cin_p,
                           int cout_p, long long sk, long long sc, long long sn,
                           cudaStream_t stream) {
    const dim3 grid((kvol * cin_p + 31) / 32, (cout_p + 31) / 32);
    subm_conv_weights_k_major<<<grid, dim3(32, 8), 0, stream>>>(
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wt), kvol, cin, cout,
        cin_p, cout_p, sk, sc, sn);
    return cudaGetLastError();
}

// Both passes: feats (M, Cin_p) bf16; w (K, Cin, Cout) bf16 with element
// strides (sk, sc, sn); wt (Cout_p, K * Cin_p) bf16, written by pass 1, or
// NULL where the caller's plan is direct (sparse/cuda_subm_conv.py:plan):
// then no pass 1 runs and the gather-GEMM reads w itself (K = 1 only; an
// instantiation exists for N <= 64 without warp specialisation); out
// (M, Cout_p) f32; n the N tile's width, n_tiles of them across Cout_p,
// `stages` in the ring, ws: the warp-specialised kernel.
int run(const void* feats, const void* w, void* wt, const void* rulebook, void* out, int m,
        int cin, int cin_p, int cout, int cout_p, int kvol, long long sk, long long sc,
        long long sn, int n, int n_tiles, int stages, int ws, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    DirectWeights wd = {nullptr, sc, sn, cin, cout};
    if (wt == nullptr) {
        if (kvol != 1) return static_cast<int>(cudaErrorInvalidValue);
        wd.w = static_cast<const __nv_bfloat16*>(w);
    } else {
        cudaError_t err = launch_weights(w, wt, kvol, cin, cout, cin_p, cout_p, sk, sc, sn, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(launch_n(static_cast<const __nv_bfloat16*>(feats),
                                     static_cast<const __nv_bfloat16*>(wt), wd,
                                     static_cast<const int32_t*>(rulebook),
                                     static_cast<float*>(out), m, cin_p, cout_p, kvol, n,
                                     n_tiles, stages, ws, s));
}

}  // namespace

// Pass 1 alone, for tests.
extern "C" int subm_conv_weights(const void* w, void* wt, int kvol, int cin, int cout, int cin_p,
                                 int cout_p, long long sk, long long sc, long long sn,
                                 void* stream) {
    return static_cast<int>(launch_weights(w, wt, kvol, cin, cout, cin_p, cout_p, sk, sc, sn,
                                           static_cast<cudaStream_t>(stream)));
}

// Both passes, one entry point per channel regime, each named after the
// Pallas variant it replaces (one design serves the three).
#define SUBM_CONV_ENTRY(NAME)                                                                 \
    extern "C" int NAME(const void* feats, const void* w, void* wt, const void* rulebook,    \
                        void* out, int m, int cin, int cin_p, int cout, int cout_p, int kvol, \
                        long long sk, long long sc, long long sn, int n, int n_tiles,         \
                        int stages, int ws, void* stream) {                              \
        return run(feats, w, wt, rulebook, out, m, cin, cin_p, cout, cout_p, kvol, sk, sc,    \
                   sn, n, n_tiles, stages, ws, stream);                                       \
    }
SUBM_CONV_ENTRY(subm_conv_k2c_shift2)
SUBM_CONV_ENTRY(subm_conv_k2c_shift1)
SUBM_CONV_ENTRY(subm_conv_k2ab_chunked)
