// Kernel K2: the forward of the submanifold sparse convolution, a gather-GEMM
// over a plain (M, K) rulebook, hand-written for Hopper (sm_90a).
//
//   out[i, :] = sum_k sum_c feats[nbr[i, k], c] * W[k, c, :]
//
// feats (M, Cin) bf16, W (K, Cin, Cout) bf16, rulebook (M, K) int32 with any
// value outside [0, M) (the engine writes M) marking an absent neighbour;
// out (M, Cout) float32, the sum accumulated in float32. Cin and Cout are
// multiples of 8 (the wrapper pads them with zeros), M and Cout need not be
// multiples of the tiles.
//
// Replaces the three forward Pallas kernels of
// seggroup_tpu/sparse/pallas_conv.py, which compute the same function over a
// windowed plan of the rulebook:
//   _fwd_kernel         (pallas_conv.py:72,  K2a, full-width one-hot gather)
//   _fwd_kernel_chunked (pallas_conv.py:158, K2b, chunked one-hot, Cin > 64)
//   _fwd_kernel_packed  (pallas_conv.py:343, K2c, lane-packed, Cin <= 64)
// The window plan, the one-hot gather and the lane packing work around the
// TPU's slow row gathers; here each CTA gathers its rows straight from the
// rulebook. One template serves the three channel regimes; the
// instantiations are named after the Pallas variant each one replaces:
//   subm_conv_k2c_shift2   Cin <= 32   Cin chunk 32, Cout tile 32
//   subm_conv_k2c_shift1   Cin <= 64   Cin chunk 64, Cout tile 64
//   subm_conv_k2ab_chunked Cin > 64    Cin chunk 64, Cout tile 128
//
// Design. A CTA of four warps owns 64 output rows and one Cout tile. For each
// of the K offsets it reads the tile's rulebook column; when no row of the
// tile has a neighbour at that offset (__syncthreads_or) the offset is
// skipped. Otherwise, per Cin chunk, it gathers the neighbour rows into
// shared memory as bf16 (16-byte loads, zeros for absent neighbours), loads
// the W[k] chunk, and accumulates with bf16 -> f32 tensor-core products
// (WMMA 16x16x16, mma.sync). The float32 tile goes out through shared
// memory, masked on the ragged edges.
//
// Bound. The function must read the bf16 features (M*Cin*2 bytes), the
// rulebook (M*K*4), the weights (K*Cin*Cout*2) and write the f32 output
// (M*Cout*4), at 3.35 TB/s; it does 2*Cin*Cout operations per present
// (row, offset) pair, at 989 TFLOP/s of bf16. At the MinkUNet shapes of
// level 0 the present pairs are few (about 4 of 27 per row) and the bytes
// bound it; at the coarse levels the products do.
//
// What the simple design leaves undone: no wgmma, no TMA and no cp.async
// pipeline (the gather and the products of one chunk do not overlap); a row
// is gathered once per Cout tile; an offset is skipped only when the whole
// tile lacks it, so absent rows inside a present offset still cost products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // output rows per CTA
constexpr int THREADS = 128;  // four warps

template <int KC, int BN, int WARPS_M>
struct Tile {
    static constexpr int WARPS_N = 4 / WARPS_M;
    static constexpr int WTM = BM / WARPS_M;  // rows of one warp's tile
    static constexpr int WTN = BN / WARPS_N;  // columns of one warp's tile
    static constexpr int FM = WTM / 16;
    static constexpr int FN = WTN / 16;
    static constexpr int LDA = KC + 8;  // padded strides (multiples of 8 bf16 /
    static constexpr int LDB = BN + 8;  // 4 floats, as WMMA asks)
    static constexpr int LDC = BN + 4;
    static constexpr int A_BYTES = BM * LDA * 2;
    static constexpr int AB_BYTES = A_BYTES + KC * LDB * 2;
    static constexpr int C_BYTES = BM * LDC * 4;
    // the f32 staging tile reuses the operand buffers after the last product
    static constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
    static_assert(WARPS_M * WARPS_N == 4 && WTM % 16 == 0 && WTN % 16 == 0, "warp tiling");
    static_assert(KC % 16 == 0 && A_BYTES % 32 == 0, "alignment");
};

template <int KC, int BN, int WARPS_M>
__global__ void __launch_bounds__(THREADS)
subm_gather_gemm(const __nv_bfloat16* __restrict__ feats,
                 const __nv_bfloat16* __restrict__ weights,
                 const int32_t* __restrict__ rulebook,
                 float* __restrict__ out, int m, int cin, int cout, int kvol) {
    using T = Tile<KC, BN, WARPS_M>;
    constexpr int VA = KC / 8;  // 16-byte vectors per gathered row chunk
    constexpr int VB = BN / 8;  // 16-byte vectors per weight row chunk

    __shared__ __align__(128) unsigned char smem[T::SMEM];
    __shared__ int nbr_s[BM];
    __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem + T::A_BYTES);
    float* c_s = reinterpret_cast<float*>(smem);

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wm = warp / T::WARPS_N;
    const int wn = warp % T::WARPS_N;
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
    for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k = 0; k < kvol; ++k) {
        // the tile's rulebook column; the barrier also closes the last
        // chunk's reads of nbr_s
        int present = 0;
        if (tid < BM) {
            const int row = m0 + tid;
            int j = row < m ? rulebook[(size_t)row * kvol + k] : -1;
            j = (j >= 0 && j < m) ? j : -1;
            nbr_s[tid] = j;
            present = j >= 0;
        }
        if (!__syncthreads_or(present)) continue;

        const __nv_bfloat16* wk = weights + (size_t)k * cin * cout;
        for (int c0 = 0; c0 < cin; c0 += KC) {
            for (int v = tid; v < BM * VA; v += THREADS) {
                const int r = v / VA, cv = v % VA;
                const int c = c0 + cv * 8;
                const int j = nbr_s[r];
                uint4 val = zero;
                if (j >= 0 && c < cin)
                    val = *reinterpret_cast<const uint4*>(feats + (size_t)j * cin + c);
                *reinterpret_cast<uint4*>(a_s + r * T::LDA + cv * 8) = val;
            }
            for (int v = tid; v < KC * VB; v += THREADS) {
                const int r = v / VB, cv = v % VB;
                const int c = c0 + r, n = n0 + cv * 8;
                uint4 val = zero;
                if (c < cin && n < cout)
                    val = *reinterpret_cast<const uint4*>(wk + (size_t)c * cout + n);
                *reinterpret_cast<uint4*>(b_s + r * T::LDB + cv * 8) = val;
            }
            __syncthreads();
            // chunk columns past Cin hold zeros; skip their whole 16-steps
            const int left = (cin - c0 + 15) / 16;
            const int ksteps = left < KC / 16 ? left : KC / 16;
            for (int ks = 0; ks < ksteps; ++ks) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[T::FM];
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[T::FN];
#pragma unroll
                for (int i = 0; i < T::FM; ++i)
                    wmma::load_matrix_sync(af[i], a_s + (wm * T::WTM + i * 16) * T::LDA + ks * 16,
                                           T::LDA);
#pragma unroll
                for (int j = 0; j < T::FN; ++j)
                    wmma::load_matrix_sync(bf[j], b_s + (ks * 16) * T::LDB + wn * T::WTN + j * 16,
                                           T::LDB);
#pragma unroll
                for (int i = 0; i < T::FM; ++i)
#pragma unroll
                    for (int j = 0; j < T::FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
            }
            __syncthreads();
        }
    }

#pragma unroll
    for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j)
            wmma::store_matrix_sync(c_s + (wm * T::WTM + i * 16) * T::LDC + wn * T::WTN + j * 16,
                                    acc[i][j], T::LDC, wmma::mem_row_major);
    __syncthreads();
    for (int v = tid; v < BM * (BN / 4); v += THREADS) {
        const int r = v / (BN / 4), cv = v % (BN / 4);
        const int row = m0 + r, n = n0 + cv * 4;
        if (row < m && n < cout)
            *reinterpret_cast<float4*>(out + (size_t)row * cout + n) =
                *reinterpret_cast<const float4*>(c_s + r * T::LDC + cv * 4);
    }
}

template <int KC, int BN, int WARPS_M>
int launch(const void* feats, const void* weights, const void* rulebook, void* out, int m,
           int cin, int cout, int kvol, cudaStream_t stream) {
    const dim3 grid((m + BM - 1) / BM, (cout + BN - 1) / BN);
    subm_gather_gemm<KC, BN, WARPS_M><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(feats), static_cast<const __nv_bfloat16*>(weights),
        static_cast<const int32_t*>(rulebook), static_cast<float*>(out), m, cin, cout, kvol);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The instantiations, each named after the Pallas variant it replaces.
extern "C" int subm_conv_k2c_shift2(const void* feats, const void* weights, const void* rulebook,
                                    void* out, int m, int cin, int cout, int kvol, void* stream) {
    return launch<32, 32, 4>(feats, weights, rulebook, out, m, cin, cout, kvol,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int subm_conv_k2c_shift1(const void* feats, const void* weights, const void* rulebook,
                                    void* out, int m, int cin, int cout, int kvol, void* stream) {
    return launch<64, 64, 2>(feats, weights, rulebook, out, m, cin, cout, kvol,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int subm_conv_k2ab_chunked(const void* feats, const void* weights, const void* rulebook,
                                      void* out, int m, int cin, int cout, int kvol, void* stream) {
    return launch<64, 128, 2>(feats, weights, rulebook, out, m, cin, cout, kvol,
                              static_cast<cudaStream_t>(stream));
}
