// One-token GQA attention over a KV cache (flash decoding), dense or paged.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/decode_attention.py:
//   * _decode_kernel        (pl.pallas_call in decode_attention_pallas) and
//   * _paged_decode_kernel  (pl.pallas_call in paged_decode_attention_pallas).
// Both are one template here; they differ only in how a key position maps
// to a cache row (contiguous per sequence, or through the block table), so
// the dense and the paged kernel do the same arithmetic in the same order.
//
// What bounds it on the H100: bytes.  Each (sequence, KV group) reads its
// lengths[b] keys and values once; at G query rows per group that is
// ~2*G flops per byte loaded, far below the ~295 flops/byte where the tensor
// cores become the limit.  The design therefore reads every K/V element
// exactly once per KV group (all G query heads of the group share one
// staged tile), stops at lengths[b] instead of sweeping the whole cache,
// and issues 16-byte loads.  It does not yet split the sequence across
// CTAs: with B*KV CTAs a small batch leaves most of the 132 SMs idle, which
// a split-KV pass with a log-sum-exp combine would fix.
//
// Per CTA (one batch row b, one KV group kv, 128 threads):
//   q rows of the group are held in shared memory as float;
//   for each tile of kTile keys below lengths[b]:
//     the K and V rows are staged in shared memory (zeros past the length);
//     warp w computes the scores of keys w, w+4, ... for every query row;
//     warp w updates the online softmax (m, l in float) of rows w, w+4, ...;
//     thread d accumulates output column d of every row in float registers.
//   out = acc / max(l, 1e-30), as the TPU kernel writes it.
// Page table entries below zero read page 0 and are masked by the length,
// as in the TPU kernel.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // keys per tile: one lane per key in the softmax step
constexpr int kMaxG = 16;   // query heads per KV group

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q,            // (B, H, HD)
              const T* __restrict__ k,            // dense (B, S, KV, HD) | paged (P, page, KV, HD)
              const T* __restrict__ v,
              const int* __restrict__ block_tables,  // paged: (B, PP)
              const int* __restrict__ lengths,       // (B,)
              T* __restrict__ out,                // (B, H, HD)
              int H, int KV, int S, int page, int PP, float scale) {
  static_assert(HD % 32 == 0 && HD <= kThreads, "head_dim must be 32, 64 or 128");
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = HD / kVec;
  __shared__ float q_s[kMaxG][HD];
  __shared__ __align__(16) unsigned char k_raw[kTile * HD * sizeof(T)];
  __shared__ __align__(16) unsigned char v_raw[kTile * HD * sizeof(T)];
  __shared__ float p_s[kMaxG][kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  T* k_s = reinterpret_cast<T*>(k_raw);
  T* v_s = reinterpret_cast<T*>(v_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KV, kv = blockIdx.x % KV;
  const int G = H / KV;
  const int cap = PAGED ? PP * page : S;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);

  const T* qb = q + ((size_t)b * H + (size_t)kv * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) q_s[i / HD][i % HD] = to_float(qb[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    // Stage the K/V rows of positions [t0, t0 + kTile) of group kv.
    for (int i = tid; i < kTile * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
      const int pos = t0 + r;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (pos < len) {
        size_t row;
        if (PAGED) {
          int pg = block_tables[(size_t)b * PP + pos / page];
          pg = pg < 0 ? 0 : pg;
          row = ((size_t)pg * page + pos % page) * KV + kv;
        } else {
          row = ((size_t)b * S + pos) * KV + kv;
        }
        kx = *reinterpret_cast<const uint4*>(k + row * HD + c);
        vx = *reinterpret_cast<const uint4*>(v + row * HD + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * HD + c) = kx;
      *reinterpret_cast<uint4*>(v_s + r * HD + c) = vx;
    }
    __syncthreads();

    // Scores: warp w takes keys w, w + kWarps, ...; lanes split head_dim.
    for (int j = warp; j < kTile; j += kWarps) {
      float kr[HD / 32];
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) kr[i] = to_float(k_s[j * HD + lane + 32 * i]);
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) part = fmaf(q_s[g][lane + 32 * i], kr[i], part);
        part = warp_sum(part);
        if (lane == 0) p_s[g][j] = part * scale;
      }
    }
    __syncthreads();

    // Online softmax: warp w takes query rows w, w + kWarps, ...; lane = key.
    const bool valid = t0 + lane < len;
    for (int g = warp; g < G; g += kWarps) {
      const float s = valid ? p_s[g][lane] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      p_s[g][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P @ V: thread d owns output column d of every query row.
    if (tid < HD) {
      float pv[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) pv[g] = 0.f;
      const int jmax = min(kTile, len - t0);
      for (int j = 0; j < jmax; ++j) {
        const float vj = to_float(v_s[j * HD + tid]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) pv[g] = fmaf(p_s[g][j], vj, pv[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = acc[g] * alpha_s[g] + pv[g];
    }
    __syncthreads();
  }

  if (tid < HD) {
    T* ob = out + ((size_t)b * H + (size_t)kv * G) * HD;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) ob[(size_t)g * HD + tid] = from_float<T>(acc[g] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, bool PAGED>
int launch(const void* q, const void* k, const void* v, const int* block_tables,
           const int* lengths, void* out, int B, int H, int KV, int S, int page,
           int PP, int hd, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxG) return (int)cudaErrorInvalidValue;
  if (PAGED && (page <= 0 || PP <= 0)) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)hd);
  const dim3 grid((unsigned)(B * KV));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32:
      decode_kernel<T, 32, PAGED><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, block_tables, lengths, ot, H, KV, S, page, PP, scale);
      break;
    case 64:
      decode_kernel<T, 64, PAGED><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, block_tables, lengths, ot, H, KV, S, page, PP, scale);
      break;
    case 128:
      decode_kernel<T, 128, PAGED><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, block_tables, lengths, ot, H, KV, S, page, PP, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

extern "C" {

// Dense cache: q (B, H, hd); k, v (B, S, KV, hd); lengths (B,) int32.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const int* lengths, void* out, int B, int H, int KV,
                           int S, int hd, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float, false>(q, k, v, nullptr, lengths, out, B, H, KV, S, 0, 0, hd, st);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16, false>(q, k, v, nullptr, lengths, out, B, H, KV, S, 0,
                                               0, hd, st);
  return (int)cudaErrorInvalidValue;
}

// Paged pool: q (B, H, hd); pools (P, page, KV, hd); block_tables (B, PP)
// int32 page ids (< 0 = unused); lengths (B,) int32.
int repro_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                 const int* block_tables, const int* lengths, void* out,
                                 int B, int H, int KV, int page, int PP, int hd, int dtype,
                                 void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float, true>(q, k_pool, v_pool, block_tables, lengths, out, B, H, KV,
                                      0, page, PP, hd, st);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16, true>(q, k_pool, v_pool, block_tables, lengths, out, B,
                                              H, KV, 0, page, PP, hd, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
