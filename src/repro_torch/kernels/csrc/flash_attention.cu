// Causal / sliding-window GQA attention forward (prefill), flash style.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (pl.pallas_call in flash_attention_pallas).
//
// What bounds it on the H100: operations, for prompts of more than a few
// hundred tokens.  A 64-query x 64-key tile does 2*64*64*hd flops for QK^T
// and as many for PV on 2*64*hd loaded elements, so the tensor-core rate
// (989 TFLOP/s dense bf16) is the roofline, with the bytes (each q, k, v,
// out element once) close behind at S 512.
//
// bfloat16, the serving path (flash_mma_kernel): FlashAttention-2 structure
// on the tensor cores.
//   * CTA = 4 warps = 64 query rows of one head; warp w owns rows 16w..16w+15.
//   * Shared memory stays bf16: the Q tile (loaded once, then held in
//     registers as mma A fragments through ldmatrix) and a two-stage ring of
//     64-key K/V tiles filled by 16-byte cp.async.cg.  Tile t+1 is in flight
//     while tile t is computed; one __syncthreads per tile.  Rows are padded
//     by 16 bytes, so ldmatrix and cp.async hit 32 distinct banks.  At hd 128
//     that is 5 x 17,408 B = 87,040 B, and two CTAs fit on an SM.
//   * S = Q K^T and O += P V both run on mma.sync.aligned.m16n8k16.row.col.
//     f32.bf16.bf16.f32 (K through ldmatrix, V through ldmatrix.trans).
//   * The online softmax (m, l in float) runs in the accumulator layout in
//     registers, base 2 with the scale folded in; the row max and the final
//     row sum are reduced across the 4 lanes of a quad with shuffles.
//   * P is rounded to bf16 in registers and fed as the A operand of P V,
//     as the TPU kernel rounds it (p.astype(v.dtype)); l sums the float p.
//     P never goes through shared memory.
//   * Causal / window tile skipping as before; per-element masks only on
//     tiles that cross the diagonal, the window edge or Sk.  Query tiles run
//     with the most key tiles first (q tile on the slowest grid axis,
//     reversed), so the causal imbalance leaves no tail.
// float32, the correctness contract (flash_fma_kernel): the products stay
// float FMAs on the CUDA cores.  Tensor cores take float32 only as TF32,
// which would break the 2e-4 kernel and 1e-3 full-depth float32 checks.
//
// Every CTA: out = acc / max(l, 1e-30).  Ragged edges (Sq, Sk not multiples
// of the tile) are masked here; the TPU's divisibility rules do not apply.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kLog2e = 1.4426950408889634f;

// Keys a query tile can see: below the causal limit of its last row, from
// the tile holding the first key inside the window of its first row.
__device__ __forceinline__ void key_range(int q0, int Sk, int causal, int window, int* kbeg,
                                          int* kend) {
  *kend = causal ? min(Sk, q0 + kBQ) : Sk;
  *kbeg = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    *kbeg = lo > 0 ? (lo / kBK) * kBK : 0;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kBQ + 4 * kBK) * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,   // (B, Sq, H, HD)
                 const __nv_bfloat16* __restrict__ k,   // (B, Sk, KV, HD)
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out,       // (B, Sq, H, HD)
                 int Sq, int Sk, int H, int KV, int causal, int window,
                 float scale_log2) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  using bf16 = __nv_bfloat16;
  constexpr int LDS = HD + 8;   // smem row: HD bf16 + 16 bytes of padding
  constexpr int UPR = HD / 8;   // 16-byte units per row
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = HD / 8;    // 8-column output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // kBQ x LDS
  bf16* Ks = Qs + kBQ * LDS;                  // 2 stages x kBK x LDS
  bf16* Vs = Ks + 2 * kBK * LDS;              // 2 stages x kBK x LDS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;     // mma fragment row / column pair
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = h / (H / KV);

  for (int i = tid; i < kBQ * UPR; i += kThreads) {
    const int r = i / UPR, u = i % UPR, qi = q0 + r;
    const bool ok = qi < Sq;
    cp_async_16(Qs + r * LDS + u * 8,
                q + (((size_t)b * Sq + (ok ? qi : 0)) * H + h) * HD + u * 8, ok);
  }
  int kbeg, kend;
  key_range(q0, Sk, causal, window, &kbeg, &kend);
  const int ntiles = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  auto load_kv = [&](int stage, int k0) {
    bf16* kd = Ks + stage * kBK * LDS;
    bf16* vd = Vs + stage * kBK * LDS;
    for (int i = tid; i < kBK * UPR; i += kThreads) {
      const int r = i / UPR, u = i % UPR, kp = k0 + r;
      const bool ok = kp < Sk;
      const size_t off = (((size_t)b * Sk + (ok ? kp : 0)) * KV + kvh) * HD + u * 8;
      cp_async_16(kd + r * LDS + u * 8, k + off, ok);
      cp_async_16(vd + r * LDS + u * 8, v + off, ok);
    }
  };
  if (ntiles > 0) load_kv(0, kbeg);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;        // rows row0 and row0 + 8

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kbeg + t * kBK;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < ntiles) load_kv((t + 1) & 1, k0 + kBK);
    cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + (t & 1) * kBK * LDS;
    const bf16* Vt = Vs + (t & 1) * kBK * LDS;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 tiles of 16x8.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16_16816(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // Online softmax in base 2; masks only where the tile needs them.
    const bool need_mask = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + kBQ - 1 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (need_mask) {
          const int qi = row0 + (e >> 1) * 8, kp = k0 + n * 8 + tq * 2 + (e & 1);
          const bool ok = kp < Sk && (!causal || kp <= qi) && (window <= 0 || kp > qi - window);
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p = x == kNegInf ? 0.f : exp2f(x - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the score accumulators, V through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16_16816(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16_16816(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = row0 + i * 8;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* orow = out + (((size_t)b * Sq + qi) * H + h) * HD + tq * 2;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + 2 * (size_t)kBK * (HD + 1) +
                          (size_t)kBQ * (kBK + 1));
}

// Each CTA keeps its query tile in shared memory, reads each K/V tile once
// for 64 query rows and register-tiles the products (4 rows x 8 score
// columns, 4 rows x hd/8 output columns per thread); rows are padded by one
// float for conflict-free column reads.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fma_kernel(const float* __restrict__ q,   // (B, Sq, H, HD)
                 const float* __restrict__ k,   // (B, Sk, KV, HD)
                 const float* __restrict__ v,
                 float* __restrict__ out,       // (B, Sq, H, HD)
                 int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
  static_assert(HD % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int LD = HD + 1;
  constexpr int LP = kBK + 1;
  constexpr int CJ = HD / 8;    // output columns per thread
  extern __shared__ float fsmem[];
  float* Qs = fsmem;            // kBQ x LD
  float* Ks = Qs + kBQ * LD;    // kBK x LD
  float* Vs = Ks + kBK * LD;    // kBK x LD
  float* Ps = Vs + kBK * LD;    // kBQ x LP

  const int tid = threadIdx.x;
  const int tr = tid >> 3;      // rows 4*tr .. 4*tr+3
  const int tc = tid & 7;       // score columns tc + 8*j, output columns tc + 8*jj
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int G = H / KV, kvh = h / G;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    Qs[r * LD + d] = qi < Sq ? q[(((size_t)b * Sq + qi) * H + h) * HD + d] : 0.f;
  }
  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) acc[i][jj] = 0.f;
  }

  int kbeg, kend;
  key_range(q0, Sk, causal, window, &kbeg, &kend);
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD, kp = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk) {
        const size_t off = (((size_t)b * Sk + kp) * KV + kvh) * HD + d;
        kx = k[off];
        vx = v[off];
      }
      Ks[c * LD + d] = kx;
      Vs[c * LD + d] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(4 * tr + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = Ks[(tc + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * tr + i;
      bool ok[8];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tc + 8 * j;
        ok[j] = kp < Sk && (!causal || kp <= qi) && (window <= 0 || kp > qi - window);
        s[i][j] *= scale;
        if (ok[j]) mt = fmaxf(mt, s[i][j]);
      }
      // the 8 threads of a row are 8 consecutive lanes of one warp
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(4 * tr + i) * LP + tc + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    const int cmax = min(kBK, kend - k0);
    for (int c = 0; c < cmax; ++c) {
      float pr[4], vb[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(4 * tr + i) * LP + c];
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) vb[jj] = Vs[c * LD + tc + 8 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) acc[i][jj] = fmaf(pr[i], vb[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * tr + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) orow[tc + 8 * jj] = acc[i][jj] / denom;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename Kernel>
int launch_kernel(Kernel kernel, size_t bytes, float scale, const void* q, const void* k,
                  const void* v, void* out, int B, int Sq, int Sk, int H, int KV, int causal,
                  int window, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // query tiles on the slowest axis, launched last tile first (see the note)
  const dim3 grid((unsigned)H, (unsigned)B, (unsigned)((Sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v, void* out, int B, int Sq,
              int Sk, int H, int KV, int causal, int window, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)HD);
  if (dtype == kBFloat16)
    return launch_kernel<__nv_bfloat16>(
        flash_mma_kernel<HD>, mma_smem_bytes<HD>(), scale * kLog2e, q, k, v, out, B, Sq, Sk,
        H, KV, causal, window, stream);
  return launch_kernel<float>(
      flash_fma_kernel<HD>, fma_smem_bytes<HD>(), scale, q, k, v, out, B, Sq, Sk, H, KV,
      causal, window, stream);
}

}  // namespace
}  // namespace repro

extern "C" {

// q (B, Sq, H, hd); k, v (B, Sk, KV, hd); out (B, Sq, H, hd).
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                          int Sq, int Sk, int H, int KV, int hd, int causal, int window,
                          int dtype, void* stream) {
  using namespace repro;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype != kFloat32 && dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || H > 65535 || B > 65535 ||
      (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_hd<32>(dtype, q, k, v, out, B, Sq, Sk, H, KV, causal, window, st);
    case 64: return launch_hd<64>(dtype, q, k, v, out, B, Sq, Sk, H, KV, causal, window, st);
    case 128: return launch_hd<128>(dtype, q, k, v, out, B, Sq, Sk, H, KV, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
