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
// and Cout are multiples of 8 (the wrapper pads them with zeros); M need not
// be a multiple of the chunk.
//
// Replaces the two weight-gradient Pallas kernels of
// seggroup_tpu/sparse/pallas_conv.py, which compute the same function over a
// windowed plan of the rulebook:
//   _dw_kernel        (pallas_conv.py:403, K3a, one-hot gather, Cin > 64)
//   _dw_kernel_packed (pallas_conv.py:371, K3b, lane-packed, Cin <= 64)
// On the TPU the grid runs in order and one VMEM-resident dW block carries
// the sum across grid steps. Here CTAs run in parallel and in no order, so
// the rows are cut into slabs: each CTA sums its slab into its own slice of
// a (slabs, K, Cin, Cout) float32 workspace, and a second pass adds the
// slabs in a fixed order. No atomics: the result is bit-identical from run
// to run. One template serves the channel regimes; the instantiations are
// named after the Pallas variant each one replaces:
//   subm_dw_k3b_shift2   Cin <= 32   Cin tile 32, Cout tile 32
//   subm_dw_k3b_shift1   Cin <= 64   Cin tile 64, Cout tile 64
//   subm_dw_k3a          Cin > 64    Cin tile 64, Cout tile 128
//
// Design. The grid is (slab, offset k, Cin tile x Cout tile); a CTA of four
// warps owns one (Cin tile, Cout tile) block of dW[k] and walks its slab in
// 64-row chunks. Per chunk it reads the rulebook column k of the chunk and
// skips the chunk when no row has that neighbour (__syncthreads_or; at the
// finest level of a MinkUNet about 4 of 27 neighbours are present). Else it
// gathers the neighbour rows of its Cin tile into shared memory as bf16
// (16-byte loads, zeros for absent rows), loads the chunk's dout rows of its
// Cout tile (zeros where the row has no neighbour), and accumulates
// A^T * B with bf16 -> f32 tensor-core products (WMMA 16x16x16, mma.sync): a
// col_major matrix_a fragment reads the gathered (rows, Cin) tile
// transposed. Fragments that lie wholly in the channel padding are skipped.
// The float32 tile goes out through shared memory, masked on the edges.
//
// Bound. The function must read the bf16 features (M*Cin*2 bytes), the bf16
// output gradient (M*Cout*2), the rulebook (M*K*4) and write the f32 dW
// (K*Cin*Cout*4), at 3.35 TB/s; it does 2*Cin*Cout operations per present
// (row, offset) pair, at 989 TFLOP/s of bf16. At the coarse levels of a
// MinkUNet the operations bound it; at the finest level, with few present
// pairs, the bytes come close.
//
// What the simple design leaves undone: no wgmma, no TMA and no cp.async
// pipeline (the gather and the products of one chunk do not overlap); a
// feature row is gathered once per Cout tile and a dout row once per Cin
// tile and offset; a chunk is skipped only when all its rows lack the
// offset, so absent rows inside a present chunk still cost products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BK = 64;        // rows per chunk: the depth of one product step
constexpr int THREADS = 128;  // four warps

template <int TM, int TN, int WARPS_M>
struct Tile {
    static constexpr int WARPS_N = 4 / WARPS_M;
    static constexpr int WTM = TM / WARPS_M;  // Cin rows of one warp's tile
    static constexpr int WTN = TN / WARPS_N;  // Cout columns of one warp's tile
    static constexpr int FM = WTM / 16;
    static constexpr int FN = WTN / 16;
    static constexpr int LDA = TM + 8;  // padded strides (multiples of 8 bf16 /
    static constexpr int LDB = TN + 8;  // 4 floats, as WMMA asks)
    static constexpr int LDC = TN + 4;
    static constexpr int A_BYTES = BK * LDA * 2;
    static constexpr int AB_BYTES = A_BYTES + BK * LDB * 2;
    static constexpr int C_BYTES = TM * LDC * 4;
    // the f32 staging tile reuses the operand buffers after the last product
    static constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
    static_assert(WARPS_M * WARPS_N == 4 && WTM % 16 == 0 && WTN % 16 == 0, "warp tiling");
    static_assert(A_BYTES % 32 == 0, "alignment");
};

// at most 128 registers a thread, so that four CTAs fit an SM
template <int TM, int TN, int WARPS_M>
__global__ void __launch_bounds__(THREADS, 4)
subm_dw_gemm(const __nv_bfloat16* __restrict__ feats,
             const __nv_bfloat16* __restrict__ dout,
             const int32_t* __restrict__ rulebook,
             float* __restrict__ ws, int m, int cin, int cout, int kvol,
             int slab_rows, int tiles_n) {
    using T = Tile<TM, TN, WARPS_M>;
    constexpr int VA = TM / 8;  // 16-byte vectors per gathered row chunk
    constexpr int VB = TN / 8;  // 16-byte vectors per dout row chunk

    __shared__ __align__(128) unsigned char smem[T::SMEM];
    __shared__ int nbr_s[BK];
    __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem + T::A_BYTES);
    float* c_s = reinterpret_cast<float*>(smem);

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wm = warp / T::WARPS_N;
    const int wn = warp % T::WARPS_N;
    const int slab = blockIdx.x;
    const int k = blockIdx.y;
    const int c0 = (blockIdx.z / tiles_n) * TM;
    const int n0 = (blockIdx.z % tiles_n) * TN;
    const int r_begin = slab * slab_rows;
    const int r_end = min(m, r_begin + slab_rows);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

    // fragments wholly inside the channel padding (the stem's Cin of 3, a
    // Cout of 96 in a 128-wide tile) are neither loaded nor multiplied; the
    // test depends on the warp alone, so each warp takes one branch
    bool live_m[T::FM], live_n[T::FN];
#pragma unroll
    for (int i = 0; i < T::FM; ++i) live_m[i] = c0 + wm * T::WTM + i * 16 < cin;
#pragma unroll
    for (int j = 0; j < T::FN; ++j) live_n[j] = n0 + wn * T::WTN + j * 16 < cout;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
    for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int r0 = r_begin; r0 < r_end; r0 += BK) {
        // the chunk's rulebook column; the barrier also closes the last
        // chunk's reads of nbr_s
        int present = 0;
        if (tid < BK) {
            const int row = r0 + tid;
            int j = row < r_end ? rulebook[(size_t)row * kvol + k] : -1;
            j = (j >= 0 && j < m) ? j : -1;
            nbr_s[tid] = j;
            present = j >= 0;
        }
        if (!__syncthreads_or(present)) continue;

        for (int v = tid; v < BK * VA; v += THREADS) {
            const int r = v / VA, cv = v % VA;
            const int c = c0 + cv * 8;
            const int j = nbr_s[r];
            uint4 val = zero;
            if (j >= 0 && c < cin)
                val = *reinterpret_cast<const uint4*>(feats + (size_t)j * cin + c);
            *reinterpret_cast<uint4*>(a_s + r * T::LDA + cv * 8) = val;
        }
        for (int v = tid; v < BK * VB; v += THREADS) {
            const int r = v / VB, cv = v % VB;
            const int n = n0 + cv * 8;
            uint4 val = zero;
            // a row without the neighbour contributes nothing: skip its read
            if (nbr_s[r] >= 0 && n < cout)
                val = *reinterpret_cast<const uint4*>(dout + (size_t)(r0 + r) * cout + n);
            *reinterpret_cast<uint4*>(b_s + r * T::LDB + cv * 8) = val;
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af[T::FM];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[T::FN];
#pragma unroll
            for (int i = 0; i < T::FM; ++i)
                if (live_m[i])
                    wmma::load_matrix_sync(af[i], a_s + (ks * 16) * T::LDA + wm * T::WTM + i * 16,
                                           T::LDA);
#pragma unroll
            for (int j = 0; j < T::FN; ++j)
                if (live_n[j])
                    wmma::load_matrix_sync(bf[j], b_s + (ks * 16) * T::LDB + wn * T::WTN + j * 16,
                                           T::LDB);
#pragma unroll
            for (int i = 0; i < T::FM; ++i)
#pragma unroll
                for (int j = 0; j < T::FN; ++j)
                    if (live_m[i] && live_n[j]) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j)
            wmma::store_matrix_sync(c_s + (wm * T::WTM + i * 16) * T::LDC + wn * T::WTN + j * 16,
                                    acc[i][j], T::LDC, wmma::mem_row_major);
    __syncthreads();
    float* out = ws + ((size_t)slab * kvol + k) * cin * cout;
    for (int v = tid; v < TM * (TN / 4); v += THREADS) {
        const int r = v / (TN / 4), cv = v % (TN / 4);
        const int c = c0 + r, n = n0 + cv * 4;
        if (c < cin && n < cout)
            *reinterpret_cast<float4*>(out + (size_t)c * cout + n) =
                *reinterpret_cast<const float4*>(c_s + r * T::LDC + cv * 4);
    }
}

// out[i] = sum over s of ws[s][i], the slabs added in order 0, 1, ...
__global__ void sum_slabs(const float* __restrict__ ws, float* __restrict__ out, int slabs,
                          size_t n) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        float s = ws[i];
        for (int t = 1; t < slabs; ++t) s += ws[(size_t)t * n + i];
        out[i] = s;
    }
}

template <int TM, int TN, int WARPS_M>
int launch(const void* feats, const void* dout, const void* rulebook, void* ws, void* out,
           int m, int cin, int cout, int kvol, int slabs, int slab_rows, cudaStream_t stream) {
    const int tiles_n = (cout + TN - 1) / TN;
    const dim3 grid(slabs, kvol, ((cin + TM - 1) / TM) * tiles_n);
    // with one slab the partial is the result
    float* dst = static_cast<float*>(slabs == 1 ? out : ws);
    subm_dw_gemm<TM, TN, WARPS_M><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(feats), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const int32_t*>(rulebook), dst, m, cin, cout, kvol, slab_rows, tiles_n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || slabs == 1) return static_cast<int>(err);
    const size_t n = (size_t)kvol * cin * cout;
    const int blocks = static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
    sum_slabs<<<blocks, 256, 0, stream>>>(static_cast<const float*>(ws),
                                          static_cast<float*>(out), slabs, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The instantiations, each named after the Pallas variant it replaces. `ws`
// holds slabs * K * Cin * Cout floats (unused when slabs == 1).
extern "C" int subm_dw_k3b_shift2(const void* feats, const void* dout, const void* rulebook,
                                  void* ws, void* out, int m, int cin, int cout, int kvol,
                                  int slabs, int slab_rows, void* stream) {
    return launch<32, 32, 2>(feats, dout, rulebook, ws, out, m, cin, cout, kvol, slabs,
                             slab_rows, static_cast<cudaStream_t>(stream));
}

extern "C" int subm_dw_k3b_shift1(const void* feats, const void* dout, const void* rulebook,
                                  void* ws, void* out, int m, int cin, int cout, int kvol,
                                  int slabs, int slab_rows, void* stream) {
    return launch<64, 64, 2>(feats, dout, rulebook, ws, out, m, cin, cout, kvol, slabs,
                             slab_rows, static_cast<cudaStream_t>(stream));
}

extern "C" int subm_dw_k3a(const void* feats, const void* dout, const void* rulebook, void* ws,
                           void* out, int m, int cin, int cout, int kvol, int slabs,
                           int slab_rows, void* stream) {
    return launch<64, 128, 2>(feats, dout, rulebook, ws, out, m, cin, cout, kvol, slabs,
                              slab_rows, static_cast<cudaStream_t>(stream));
}
