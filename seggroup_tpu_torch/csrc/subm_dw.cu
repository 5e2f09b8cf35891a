// Kernel K3: the weight gradient of the submanifold sparse convolution, a
// gathered, transposed GEMM over a plain (M, K) rulebook, hand-written for
// Hopper (sm_90a).
//
//   dW[k, c, o] = sum_i feats[nbr[i, k], c] * dout[i, o]
//
// feats (M, Cin) bf16, dout (M, Cout) bf16 (the output gradient, rounded to
// bf16 by the caller as the JAX side rounds it), rulebook (M, K) int32 with
// any value outside [0, M) (the engine writes M) marking an absent
// neighbour; dW (K, Cin, Cout) float32, the sums accumulated in float32. Cin
// and Cout are multiples of 8 (the wrapper pads them with zeros).
//
// Replaces the two weight-gradient Pallas kernels of
// seggroup_tpu/sparse/pallas_conv.py, which compute the same function over a
// windowed plan of the rulebook:
//   _dw_kernel        (pallas_conv.py:403, K3a, one-hot gather, Cin > 64)
//   _dw_kernel_packed (pallas_conv.py:371, K3b, lane-packed, Cin <= 64)
// On the TPU the grid runs in order and one VMEM-resident dW block carries
// the sum across grid steps. Here CTAs run in parallel and in no order, so
// the rows are cut into slabs: each CTA sums its slab into its own slice of
// a (slabs, K, Cin, Cout) float32 workspace, and a last pass adds the slabs
// in a fixed order. No atomics: the result is bit-identical from run to run.
//
// Bound. The function must read the bf16 features (M*Cin*2 bytes), the bf16
// output gradient (M*Cout*2), the rulebook (M*K*4) and write the f32 dW
// (K*Cin*Cout*4), at 3.35 TB/s; it does 2*Cin*Cout operations per present
// (row, offset) pair, at 989 TFLOP/s of bf16. By that count the operations
// bound every Res16UNet34C pair at the dense sites from Cin = 64 up; the
// bytes bound the narrow pairs (Cin <= 32) and the sparse bench level 0.
// What this design must move is more: each CTA gathers, for each present
// pair, TM feature values and TN gradient values from L2 (or memory), so
// it reads (TM + TN) * 2 bytes for 2 * TM * TN operations.
//
// Design, three passes:
//  1. Compaction (subm_dw_compact_pairs). One CTA per (row slab, offset k)
//     scans its slab's rows of rulebook column k and writes the present
//     pairs (row i, neighbour j), in ascending i, to its segment of a pairs
//     buffer and their number to counts (ballot + a scan over the warps).
//     The product then never touches an absent pair (half the pairs at
//     dense sites, about 86% at the bench scene's level 0) and never reads
//     the rulebook.
//  2. Product (subm_dw_gemm). Grid (slab, k, Cin tile x Cout tile), static;
//     a CTA reads its segment's count from device memory (no host read) and
//     streams the segment in stages of BK = 64 pairs through a ring of 4
//     stages in dynamic shared memory: cp.async.cg 16-byte copies of the TM
//     feature values of row j and the TN gradient values of row i,
//     zero-filled (src-size 0) past the count and in the channel padding.
//     Three stages are in flight while one is multiplied. The pair indices
//     ride in the same ring, three stages ahead of their rows (cp.async of
//     8 bytes into a shared ring of 6 slots), so no copy waits on an index
//     load. The product is A^T * B with A the (pairs x Cin) stage and B the
//     (pairs x Cout) stage, summed in float32 registers, by one of two
//     instruction paths:
//       - Cin > 32 (K3a and K3b shift 1): wgmma. One warpgroup per 64
//         channels of the Cin tile (two for K3a's 128, one for shift 1's
//         64), each an m64nNk16 product by the whole Cout tile per k16
//         step (N / 2 float32 sums a thread), both operands MN-major (the
//         transpose bits) in the canonical 128-byte-swizzled layout, which
//         the cp.async copies write directly: atoms of 8 pairs x 64
//         channels, 1,024 bytes. The copies pass to wgmma's async proxy
//         through fence.proxy.async.
//       - Cin <= 32 (K3b shift 2), whose channels fill half of wgmma's 64
//         rows: mma.sync m16n8k16, both operands loaded with
//         ldmatrix.trans from rows padded by 16 bytes (no bank conflicts);
//         fragments wholly inside the channel padding are neither loaded
//         nor multiplied (the stem's Cin of 3). Measured against wgmma at
//         the Cin <= 64 tiles (64 x 64, 64 x 128) in one run (PERF.md): 11
//         to 19% faster at (3, 32) and (32, 32), dense and at the bench
//         level 0, 5% slower at (32, 64).
//     The float32 tile goes straight from the registers to the CTA's slab
//     slice (a CTA with an empty segment writes zeros). Tiles, per channel
//     regime, with the operations per gathered byte TM*TN/(TM+TN):
//       subm_dw_k3b_shift2  Cin <= 32  32 x 32 (16.0),   Cout <= 32
//                                      32 x 64 (21.3),   Cout > 32
//       subm_dw_k3b_shift1  Cin <= 64  64 x 64 (32.0),   Cout <= 64
//                                      64 x 128 (42.7),  Cout > 64
//       subm_dw_k3a         Cin > 64   128 x 128 (64.0), Cout <= 128
//                                      128 x 256 (85.3), Cout > 128
//  3. Slab sum (sum_slabs), with more than one slab: out = ws[0] + ws[1] +
//     ..., in that order.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md) at (384, 256): the
// compaction and mma.sync on 32-pair stages, 2.38 ms; with the indices in
// the ring, 1.84 ms, of which the gathers alone took half and the products
// alone nine tenths; with wgmma, 0.98-1.00 ms, under the 1.07 ms matmul of
// the pre-gathered block. Ordering the grid so that the CTAs in flight
// share a slab, and a deeper ring, did not help.
//
// What is left undone: the gathers now set K3a's time (the rows are
// copied one by one with cp.async; a TMA gather of rows, or a producer
// warp, would free the consumer warpgroups), each stage waits for its
// wgmma to finish before the next barrier, a feature row is still gathered
// once per Cout tile and a gradient row once per Cin tile and offset, the
// compaction and the slab sum run again for every conv that shares a
// rulebook and a slab plan (a third of K3's time in a train step), and the
// compaction reads the rulebook column-wise (one int per 108-byte row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;  // pairs per stage: four k16 steps of the product

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; src_bytes = 0 writes
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes));
}

// 8 bytes, through L1 (.cg takes 16 only); src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d += a * b, m16n8k16, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading byte offset (between 64-element atoms along M or N) and
// stride byte offset (between 8-row atoms along K), in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
           static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// d += one k16 step of the tile, m64n256k16: bf16 operands, float32 sums, both
// operands MN-major (transposed) in 128-byte-swizzled shared memory
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d += one k16 step of the tile, m64n128k16: bf16 operands, float32 sums, both
// operands MN-major (transposed) in 128-byte-swizzled shared memory
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d += one k16 step of the tile, m64n64k16: bf16 operands, float32 sums, both
// operands MN-major (transposed) in 128-byte-swizzled shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

// the float32 sums of rows c and c + 8 at columns n, n + 1, where they lie
// inside (cin, cout)
__device__ __forceinline__ void store_pair(float* out, int c, int n, int cin, int cout,
                                           const float (&v)[4]) {
    if (n >= cout) return;
    if (c < cin) *reinterpret_cast<float2*>(out + (size_t)c * cout + n) = make_float2(v[0], v[1]);
    if (c + 8 < cin)
        *reinterpret_cast<float2*>(out + (size_t)(c + 8) * cout + n) = make_float2(v[2], v[3]);
}

// A stage for mma.sync: BK rows of TM feature values, then BK rows of TN
// gradient values, each row padded by 16 bytes so that the 8 rows an
// ldmatrix reads fall in 8 distinct 16-byte bank groups.
template <int TM, int TN>
struct PaddedStage {
    static constexpr int LDA = TM + 8, LDB = TN + 8;
    static constexpr int A_BYTES = BK * LDA * 2, B_BYTES = BK * LDB * 2;
    static constexpr int ALIGN = 16;  // of the ring's start, in bytes
    // byte offsets of the 16-byte piece at channel c (a multiple of 8) of row r
    __device__ static int a_offset(int r, int c) { return (r * LDA + c) * 2; }
    __device__ static int b_offset(int r, int c) { return (r * LDB + c) * 2; }
};

// A stage for wgmma: the canonical MN-major layout with the 128-byte
// swizzle, atoms of 8 pairs x 64 channels (1,024 bytes, each pair's 64
// channels one 128-byte row whose 16-byte pieces are permuted by the pair's
// row in the atom), the atoms along the channels LBO = 1,024 bytes apart and
// those along the pairs SBO bytes apart.
template <int TM, int TN>
struct SwizzledStage {
    static constexpr int SBO_A = TM / 64 * 1024, SBO_B = TN / 64 * 1024;
    static constexpr int A_BYTES = BK / 8 * SBO_A, B_BYTES = BK / 8 * SBO_B;
    static constexpr int ALIGN = 1024;  // the swizzle's pattern repeats every 1,024 bytes
    __device__ static int offset(int r, int c, int sbo) {
        return (r / 8) * sbo + (c / 64) * 1024 + (r % 8) * 128 + (((c / 8) % 8) ^ (r % 8)) * 16;
    }
    __device__ static int a_offset(int r, int c) { return offset(r, c, SBO_A); }
    __device__ static int b_offset(int r, int c) { return offset(r, c, SBO_B); }
};

// The products of one CTA through mma.sync: WARPS_M x WARPS_N warps, each a
// (TM / WARPS_M) x (TN / WARPS_N) block of the tile in registers.
template <int TM_, int TN_, int WARPS_M, int WARPS_N>
struct MmaSync {
    static constexpr int TM = TM_, TN = TN_, THREADS = 32 * WARPS_M * WARPS_N;
    static constexpr bool ASYNC_PROXY = false;
    using Stage = PaddedStage<TM, TN>;
    static constexpr int WTM = TM / WARPS_M;  // Cin rows of one warp's block
    static constexpr int WTN = TN / WARPS_N;  // Cout columns of one warp's block
    static constexpr int FM = WTM / 16;       // m16 fragments of a warp
    static constexpr int FN = WTN / 8;        // n8 fragments of a warp
    static_assert(WTM % 16 == 0 && WTN % 16 == 0, "warp tiling");

    float acc[FM][FN][4];
    bool live_m[FM], live_n[FN];
    int wm, wn, lane, a_lane, b_lane;

    __device__ MmaSync(int c0, int n0, int cin, int cout) {
        const int warp = threadIdx.x / 32;
        lane = threadIdx.x % 32;
        wm = warp / WARPS_N;
        wn = warp % WARPS_N;
        // fragments wholly inside the channel padding are neither loaded nor
        // multiplied; the test depends on the warp alone
#pragma unroll
        for (int i = 0; i < FM; ++i) live_m[i] = c0 + wm * WTM + i * 16 < cin;
#pragma unroll
        for (int j = 0; j < FN; ++j) live_n[j] = n0 + wn * WTN + j * 8 < cout;
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        // ldmatrix.trans addresses of this lane within a stage's k16 step: A
        // (pairs x Cin) gives the row-major m16 x k16 fragment of A^T,
        // matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15,
        // m 8-15); B (pairs x Cout) the k16 x n8 fragments of two n8 tiles,
        // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15,
        // n 8-15)
        a_lane = Stage::a_offset((lane % 8) + (lane / 16) * 8, wm * WTM + ((lane / 8) % 2) * 8);
        b_lane = Stage::b_offset((lane % 8) + ((lane / 8) % 2) * 8, wn * WTN + (lane / 16) * 8);
    }

    __device__ void stage(uint32_t a_stage, uint32_t b_stage) {
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
            uint32_t af[FM][4], bf[FN / 2][4];
#pragma unroll
            for (int i = 0; i < FM; ++i)
                if (live_m[i])
                    ldmatrix_x4_trans(af[i], a_stage + a_lane + Stage::a_offset(ks * 16, i * 16));
#pragma unroll
            for (int j = 0; j < FN / 2; ++j)
                if (live_n[2 * j])
                    ldmatrix_x4_trans(bf[j], b_stage + b_lane + Stage::b_offset(ks * 16, j * 16));
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int j = 0; j < FN; ++j)
                    if (live_m[i] && live_n[j])
                        mma_bf16(acc[i][j], af[i], bf[j / 2][(j % 2) * 2],
                                 bf[j / 2][(j % 2) * 2 + 1]);
        }
    }

    // c0-1: (m = lane / 4, n = 2 * (lane % 4) + 0, 1), c2-3: m + 8
    __device__ void store(float* out, int c0, int n0, int cin, int cout) const {
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j)
                store_pair(out, c0 + wm * WTM + i * 16 + lane / 4,
                           n0 + wn * WTN + j * 8 + (lane % 4) * 2, cin, cout, acc[i][j]);
    }
};

// The products of one CTA through wgmma: TM / 64 warpgroups, each a
// 64 x TN block of the tile in registers (TN / 2 float32 sums a thread).
template <int TM_, int TN_>
struct Wgmma {
    static constexpr int TM = TM_, TN = TN_, THREADS = 128 * (TM / 64);
    static constexpr bool ASYNC_PROXY = true;
    using Stage = SwizzledStage<TM, TN>;
    static_assert(TM % 64 == 0 && (TN == 64 || TN == 128 || TN == 256), "wgmma tiling");

    float acc[TN / 2];
    bool live;  // some of the warpgroup's 64 channels are real
    int wg, row;

    __device__ Wgmma(int c0, int n0, int cin, int cout) {
        wg = threadIdx.x / 128;
        live = c0 + wg * 64 < cin;
        // the accumulator's rows: warp w of the warpgroup holds rows 16 w ..
        // 16 w + 15, laid out in each n8 block as mma.sync's C fragment
        row = wg * 64 + (threadIdx.x % 128) / 32 * 16 + (threadIdx.x % 32) / 4;
#pragma unroll
        for (int e = 0; e < TN / 2; ++e) acc[e] = 0.0f;
    }

    __device__ void stage(uint32_t a_stage, uint32_t b_stage) {
        if (!live) return;  // the same for the whole warpgroup
#pragma unroll
        for (int e = 0; e < TN / 2; ++e) fence_operand(acc[e]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
            const uint64_t da = wgmma_desc(a_stage + ks * 2 * Stage::SBO_A + wg * 1024, 1024,
                                           Stage::SBO_A);
            const uint64_t db = wgmma_desc(b_stage + ks * 2 * Stage::SBO_B, 1024, Stage::SBO_B);
            if constexpr (TN == 256)
                wgmma_n256(acc, da, db);
            else if constexpr (TN == 128)
                wgmma_n128(acc, da, db);
            else
                wgmma_n64(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int e = 0; e < TN / 2; ++e) fence_operand(acc[e]);
    }

    __device__ void store(float* out, int c0, int n0, int cin, int cout) const {
        const int lane = threadIdx.x % 32;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
            const float sums[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
            store_pair(out, c0 + row, n0 + j * 8 + (lane % 4) * 2, cin, cout, sums);
        }
    }
};

// A CTA's ring: the products M, their stage layout, STAGES stages, and each
// thread's share of a stage's 16-byte copies.
template <class M_, int STAGES_>
struct Tile {
    using M = M_;
    using Stage = typename M::Stage;
    static constexpr int TM = M::TM, TN = M::TN, THREADS = M::THREADS, STAGES = STAGES_;
    static constexpr int VA = TM / 8;  // 16-byte copies per feature row
    static constexpr int VB = TN / 8;  // 16-byte copies per gradient row
    static constexpr int A_COPIES = BK * VA / THREADS;  // per thread and stage
    static constexpr int B_COPIES = BK * VB / THREADS;
    static constexpr int IDX_BYTES = 2 * (STAGES - 1) * BK * 8;
    // the ring, its index slots, and room to align the ring
    static constexpr int SMEM =
        STAGES * (Stage::A_BYTES + Stage::B_BYTES) + IDX_BYTES + Stage::ALIGN - 16;
    static_assert(STAGES >= 2 && SMEM <= 227 * 1024, "ring");
    static_assert(A_COPIES >= 1 && BK * VA % THREADS == 0 && THREADS % VA == 0, "A copies");
    static_assert(B_COPIES >= 1 && BK * VB % THREADS == 0 && THREADS % VB == 0, "B copies");
};

// Pass 1: one CTA per (row slab, offset k) writes the present pairs (row
// i, neighbour j) of its slab's rows, in ascending i, to its segment of
// `pairs` (slab_rows entries) and their number to counts[slab * K + k]: a
// ballot per warp and a scan over the warps per 256-row step.
constexpr int SCAN = 256;

__global__ void __launch_bounds__(SCAN)
subm_dw_compact_pairs(const int32_t* __restrict__ rulebook, int2* __restrict__ pairs,
                      int* __restrict__ counts, int m, int kvol, int slab_rows) {
    __shared__ int warp_n[SCAN / 32];
    const int slab = blockIdx.x, k = blockIdx.y;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int r_begin = slab * slab_rows;
    const int r_end = min(m, r_begin + slab_rows);
    int2* seg = pairs + ((size_t)slab * kvol + k) * slab_rows;
    int total = 0;  // pairs written before this step, the same in every thread
    for (int r0 = r_begin; r0 < r_end; r0 += SCAN) {
        const int row = r0 + threadIdx.x;
        const int j = row < r_end ? rulebook[(size_t)row * kvol + k] : -1;
        const bool present = j >= 0 && j < m;
        const unsigned ballot = __ballot_sync(0xffffffffu, present);
        if (lane == 0) warp_n[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, step = 0;
#pragma unroll
        for (int w = 0; w < SCAN / 32; ++w) {
            before += w < warp ? warp_n[w] : 0;
            step += warp_n[w];
        }
        if (present)
            seg[total + before + __popc(ballot & ((1u << lane) - 1u))] = make_int2(row, j);
        total += step;
        __syncthreads();  // warp_n is rewritten by the next step
    }
    if (threadIdx.x == 0) counts[slab * kvol + k] = total;
}

// Pass 2: one CTA per (slab, offset k, Cin tile x Cout tile) sums
// feats[j, tile]^T * dout[i, tile] over its segment's pairs.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
subm_dw_gemm(const __nv_bfloat16* __restrict__ feats, const __nv_bfloat16* __restrict__ dout,
             const int2* __restrict__ pairs, const int* __restrict__ counts,
             float* __restrict__ ws, int cin, int cout, int kvol, int slab_rows, int tiles_n) {
    using Stage = typename T::Stage;
    constexpr int S = T::STAGES, L = T::STAGES - 1;  // L stages in flight
    extern __shared__ __align__(16) unsigned char smem[];
    const uint32_t base = (smem_addr(smem) + Stage::ALIGN - 1) & ~(Stage::ALIGN - 1u);
    const uint32_t a_ring = base, b_ring = base + S * Stage::A_BYTES;
    // the pair indices of stage t sit in slot t % 2L from L iterations
    // before their stage is copied, so no copy waits for an index
    int2* idx_s = reinterpret_cast<int2*>(smem + (b_ring + S * Stage::B_BYTES - smem_addr(smem)));

    const int tid = threadIdx.x;
    const int slab = blockIdx.x;
    const int k = blockIdx.y;
    const int c0 = (blockIdx.z / tiles_n) * T::TM;
    const int n0 = (blockIdx.z % tiles_n) * T::TN;
    const int count = counts[slab * kvol + k];
    const int2* seg = pairs + ((size_t)slab * kvol + k) * slab_rows;
    const int stages = (count + BK - 1) / BK;

    // this thread's copies: rows a_row0 + u * (THREADS / VA) of the feature
    // stage at channel column a_col, and likewise for the gradient stage
    const int a_row0 = tid / T::VA, a_col = (tid % T::VA) * 8;
    const int b_row0 = tid / T::VB, b_col = (tid % T::VB) * 8;
    const bool a_live = c0 + a_col < cin;
    const bool b_live = n0 + b_col < cout;

    // the indices of stage t: one 8-byte copy per pair, none past the count
    auto copy_indices = [&](int t) {
        if (tid < BK) {
            const int p = t * BK + tid;
            cp_async8(smem_addr(idx_s + (t % (2 * L)) * BK + tid), seg + (p < count ? p : 0),
                      p < count ? 8 : 0);
        }
    };
    // the rows of stage t into ring slot t % S
    auto copy_stage = [&](int t) {
        const int2* idx = idx_s + (t % (2 * L)) * BK;
        const uint32_t a_stage = a_ring + (t % S) * Stage::A_BYTES;
        const uint32_t b_stage = b_ring + (t % S) * Stage::B_BYTES;
#pragma unroll
        for (int u = 0; u < T::A_COPIES; ++u) {
            const int r = a_row0 + u * (T::THREADS / T::VA);
            const bool on = a_live && t * BK + r < count;
            const __nv_bfloat16* src = on ? feats + (size_t)idx[r].y * cin + c0 + a_col : feats;
            cp_async16(a_stage + Stage::a_offset(r, a_col), src, on ? 16 : 0);
        }
#pragma unroll
        for (int u = 0; u < T::B_COPIES; ++u) {
            const int r = b_row0 + u * (T::THREADS / T::VB);
            const bool on = b_live && t * BK + r < count;
            const __nv_bfloat16* src = on ? dout + (size_t)idx[r].x * cout + n0 + b_col : dout;
            cp_async16(b_stage + Stage::b_offset(r, b_col), src, on ? 16 : 0);
        }
    };

    typename T::M math(c0, n0, cin, cout);

    // prologue: the indices of stages 0 .. L-1 in one group, then group t
    // (t < L) holds the rows of stage t and the indices of stage t + L
    for (int t = 0; t < L; ++t) copy_indices(t);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int t = 0; t < L; ++t) {
        if (t < stages) {
            copy_stage(t);
            copy_indices(t + L);
        }
        cp_async_commit();
    }
    for (int s = 0; s < stages; ++s) {
        // group s (the rows of stage s, the indices of stage s + L) has landed
        // for every thread, and every thread is done with stage s - 1, whose
        // slots the next copies reuse
        cp_async_wait<L - 1>();
        if constexpr (T::M::ASYNC_PROXY) fence_proxy_async();
        __syncthreads();
        const int next = s + L;
        if (next < stages) {
            copy_stage(next);
            copy_indices(next + L);
        }
        cp_async_commit();
        math.stage(a_ring + (s % S) * Stage::A_BYTES, b_ring + (s % S) * Stage::B_BYTES);
    }
    cp_async_wait<0>();
    math.store(ws + ((size_t)slab * kvol + k) * cin * cout, c0, n0, cin, cout);
}

// Pass 3: out[i] = sum over s of ws[s][i], the slabs added in order 0, 1, ...
__global__ void sum_slabs(const float* __restrict__ ws, float* __restrict__ out, int slabs,
                          size_t n) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        float s = ws[i];
        for (int t = 1; t < slabs; ++t) s += ws[(size_t)t * n + i];
        out[i] = s;
    }
}

int launch_sum(const void* ws, void* out, int slabs, size_t n, cudaStream_t stream) {
    const int blocks = static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
    sum_slabs<<<blocks, 256, 0, stream>>>(static_cast<const float*>(ws),
                                          static_cast<float*>(out), slabs, n);
    return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const void* feats, const void* dout, const void* pairs, const void* counts,
           void* ws, void* out, int cin, int cout, int kvol, int slabs, int slab_rows,
           cudaStream_t stream) {
    // above 48 KB of dynamic shared memory a kernel must ask for it, once
    static cudaError_t raised = cudaFuncSetAttribute(
        subm_dw_gemm<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (raised != cudaSuccess) return static_cast<int>(raised);
    const int tiles_n = (cout + T::TN - 1) / T::TN;
    const dim3 grid(slabs, kvol, ((cin + T::TM - 1) / T::TM) * tiles_n);
    // with one slab the partial is the result
    float* dst = static_cast<float*>(slabs == 1 ? out : ws);
    subm_dw_gemm<T><<<grid, T::THREADS, T::SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(feats), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const int2*>(pairs), static_cast<const int*>(counts), dst, cin, cout, kvol,
        slab_rows, tiles_n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || slabs == 1) return static_cast<int>(err);
    return launch_sum(ws, out, slabs, (size_t)kvol * cin * cout, stream);
}

// the narrow Cout tile where Cout fits it, else the wide one
// (sparse/cuda_subm_dw.py:tile picks the same)
template <class Narrow, class Wide>
int launch_regime(const void* feats, const void* dout, const void* pairs, const void* counts,
                  void* ws, void* out, int cin, int cout, int kvol, int slabs, int slab_rows,
                  void* stream) {
    static_assert(Narrow::TM == Wide::TM, "one Cin tile per regime");
    auto s = static_cast<cudaStream_t>(stream);
    if (cout <= Narrow::TN)
        return launch<Narrow>(feats, dout, pairs, counts, ws, out, cin, cout, kvol, slabs,
                              slab_rows, s);
    return launch<Wide>(feats, dout, pairs, counts, ws, out, cin, cout, kvol, slabs, slab_rows,
                        s);
}

}  // namespace

// The compaction pass: `pairs` holds slabs * K * slab_rows int2, `counts`
// slabs * K ints.
extern "C" int subm_dw_compact(const void* rulebook, void* pairs, void* counts, int m,
                               int kvol, int slabs, int slab_rows, void* stream) {
    subm_dw_compact_pairs<<<dim3(slabs, kvol), SCAN, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rulebook), static_cast<int2*>(pairs),
        static_cast<int*>(counts), m, kvol, slab_rows);
    return static_cast<int>(cudaGetLastError());
}

// The slab sum alone: ws (slabs, n) float32 -> out (n,).
extern "C" int subm_dw_sum_slabs(const void* ws, void* out, int slabs, size_t n, void* stream) {
    return launch_sum(ws, out, slabs, n, static_cast<cudaStream_t>(stream));
}

// The product over the compacted pairs and the slab sum, one entry point per
// channel regime, each named after the Pallas variant it replaces. `ws`
// holds slabs * K * Cin * Cout floats (unused when slabs == 1).
extern "C" int subm_dw_k3b_shift2(const void* feats, const void* dout, const void* pairs,
                                  const void* counts, void* ws, void* out, int cin, int cout,
                                  int kvol, int slabs, int slab_rows, void* stream) {
    return launch_regime<Tile<MmaSync<32, 32, 2, 2>, 4>, Tile<MmaSync<32, 64, 1, 4>, 4>>(
        feats, dout, pairs, counts, ws, out, cin, cout, kvol, slabs, slab_rows, stream);
}

extern "C" int subm_dw_k3b_shift1(const void* feats, const void* dout, const void* pairs,
                                  const void* counts, void* ws, void* out, int cin, int cout,
                                  int kvol, int slabs, int slab_rows, void* stream) {
    return launch_regime<Tile<Wgmma<64, 64>, 4>, Tile<Wgmma<64, 128>, 4>>(
        feats, dout, pairs, counts, ws, out, cin, cout, kvol, slabs, slab_rows, stream);
}

extern "C" int subm_dw_k3a(const void* feats, const void* dout, const void* pairs,
                           const void* counts, void* ws, void* out, int cin, int cout, int kvol,
                           int slabs, int slab_rows, void* stream) {
    return launch_regime<Tile<Wgmma<128, 128>, 4>, Tile<Wgmma<128, 256>, 4>>(
        feats, dout, pairs, counts, ws, out, cin, cout, kvol, slabs, slab_rows, stream);
}
