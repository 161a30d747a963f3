// Causal / sliding-window GQA attention forward (prefill), flash style.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (pl.pallas_call in flash_attention_pallas).
//
// What bounds it on the H100: operations, for prompts of more than a few
// hundred tokens.  A (64-query x 64-key) tile does 2*64*64*hd flops for QK^T
// and as many for PV on 2*64*hd loaded elements, so arithmetic intensity
// grows with the tile and the tensor-core rate (989 TFLOP/s in bf16) is the
// roofline.  This first version is right and simple rather than fast: it
// does the products with float FMAs on the CUDA cores (no mma.sync/wgmma),
// which caps it near the 67 TFLOP/s float32 rate.  What the design does
// about the bound: each CTA keeps its query tile in shared memory for the
// whole sweep, reads each K/V tile once for 64 query rows, skips tiles that
// the causal limit or the window mask out entirely, and register-tiles the
// products (4 rows x 8 columns of scores, 4 rows x hd/8 output columns per
// thread) so each shared-memory load feeds several FMAs.
//
// Per CTA (one batch row b, one query head h, one tile of kBQ queries,
// 128 threads): online softmax with float m, l and accumulator;
// out = acc / max(l, 1e-30).  Ragged edges (Sq, Sk not multiples of the
// tile) are masked here; the TPU's divisibility rules do not apply.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;
constexpr int kBK = 64;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + 2 * (size_t)kBK * (HD + 1) +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q,   // (B, Sq, H, HD)
             const T* __restrict__ k,   // (B, Sk, KV, HD)
             const T* __restrict__ v,
             T* __restrict__ out,       // (B, Sq, H, HD)
             int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
  static_assert(HD % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int LD = HD + 1;    // padded rows: conflict-free column reads
  constexpr int LP = kBK + 1;
  constexpr int CJ = HD / 8;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x LD
  float* Ks = Qs + kBQ * LD;    // kBK x LD
  float* Vs = Ks + kBK * LD;    // kBK x LD
  float* Ps = Vs + kBK * LD;    // kBQ x LP

  const int tid = threadIdx.x;
  const int tr = tid >> 3;      // rows 4*tr .. 4*tr+3
  const int tc = tid & 7;       // score columns tc + 8*j, output columns tc + 8*jj
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, kvh = h / G;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    Qs[r * LD + d] = qi < Sq ? to_float(q[(((size_t)b * Sq + qi) * H + h) * HD + d]) : 0.f;
  }
  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) acc[i][jj] = 0.f;
  }

  // Keys this query tile can see: below the causal limit of its last row,
  // from the tile holding the first key inside the window of its first row.
  const int kend = causal ? min(Sk, q0 + kBQ) : Sk;
  int kbeg = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    kbeg = lo > 0 ? (lo / kBK) * kBK : 0;
  }

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD, kp = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk) {
        const size_t off = (((size_t)b * Sk + kp) * KV + kvh) * HD + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
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
    T* orow = out + (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) orow[tc + 8 * jj] = from_float<T>(acc[i][jj] / denom);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
              int H, int KV, int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KV, causal, window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int H, int KV, int hd, int causal, int window, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_hd<T, 32>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, stream);
    case 64: return launch_hd<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, stream);
    case 128: return launch_hd<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

extern "C" {

// q (B, Sq, H, hd); k, v (B, Sk, KV, hd); out (B, Sq, H, hd).
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                          int Sq, int Sk, int H, int KV, int hd, int causal, int window,
                          int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, causal, window, st);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, hd, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
