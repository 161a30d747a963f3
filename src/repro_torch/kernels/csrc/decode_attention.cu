// One-token GQA attention over a KV cache (flash decoding), dense or paged.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/decode_attention.py:
//   * _decode_kernel        (pl.pallas_call in decode_attention_pallas) and
//   * _paged_decode_kernel  (pl.pallas_call in paged_decode_attention_pallas).
// Both are one template here; they differ only in how a key position maps
// to a cache row (contiguous per sequence, or through the block table), so
// the dense and the paged kernel do the same arithmetic in the same order.
// The dense addressing may also take a row map: query row b then reads cache
// row rows[b], so a pipeline stage decodes a microbatch of its slots in place
// instead of gathering their cache rows first.
//
// What bounds it on the H100: bytes.  Each (sequence, KV group) reads its
// lengths[b] keys and values once; at G query rows per group that is
// ~2*G flops per byte loaded, far below the ~295 flops/byte where the tensor
// cores become the limit.  So the design is about keeping enough bytes in
// flight on every SM, and reading each K/V element once per KV group.
//
// Split-KV.  Each (row, KV group) context is cut into chunks of kChunk = 128
// positions at fixed boundaries [128c, 128c + 128).  decode_chunk_kernel
// runs one CTA per (chunk, row, KV group); a CTA whose chunk starts at or
// past lengths[b] exits at once.  It writes its chunk's partial softmax
// state (m, l, acc[G][hd]) in float to scratch the wrapper allocates.
// decode_combine_kernel then merges a row's chunks in chunk order by the
// log-sum-exp rule and writes acc / max(l, 1e-30), as the TPU kernel does.
// Chunk boundaries depend on no batch size, cache length, page count or grid,
// so a row's output depends only on its own query, cache and length: the
// slotted engine (B = capacity, S = max_seq) and the paged one (pow2 rows
// and pages) give bit-equal results on the same cache.
//
// Per chunk CTA (128 threads, ~42 KB of shared memory at G 4 / hd 128 in
// bf16, so five CTAs fit on an SM and keep their tiles in flight together):
//   * K and V of the chunk stream through a two-stage ring of 64-key tiles
//     (K0, K1, V0, V1) filled by 16-byte cp.async.cg, one tile in flight
//     while the previous one is computed.  Rows are padded by 16 bytes.
//     Each CTA first turns its chunk's positions into cache rows in shared
//     memory (the paged one through the block table, read once; a negative
//     entry reads page 0 and is masked by the length), so the copies of both
//     layouts are the same code.
//   * Scores: thread t owns key t % 64 of the tile and loops over head_dim,
//     keeping the dot products of every other query row of the group
//     (t / 64, t / 64 + 2, ...) in registers; q rows are broadcast from
//     shared memory as float.  No reduction per key.  The group size is a
//     template parameter (G rounded up to a power of two, padded rows zero),
//     so no loop over the group's rows carries a runtime bound.
//   * Softmax over the chunk's <= 128 scores, one warp per query row: one
//     max and one sum reduction per row and chunk.
//   * P V: thread t owns two output columns of every row for 256/hd of the
//     tile's keys; the key groups are summed in a fixed order at the end.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // positions per chunk CTA; a multiple of the page
constexpr int kTile = 64;    // keys per ring stage
constexpr int kHalves = kThreads / kTile;  // threads per key in the score step
constexpr int kMaxG = 16;    // query heads per KV group
constexpr int kRedRow = 256; // floats per query row of the score / P V buffer

template <typename T, int HD>
struct Ring {
  static constexpr int kRow = HD * (int)sizeof(T) + 16;  // staged row + pad
  static constexpr size_t kStage = (size_t)kTile * kRow;
  static constexpr size_t kBytes = 2 * kStage;
};

// Dynamic shared memory: the ring, q_s [GP][HD], s_s [GP][kRedRow].
template <typename T, int HD, int GP>
constexpr size_t smem_bytes() {
  return Ring<T, HD>::kBytes + sizeof(float) * (size_t)GP * (HD + kRedRow);
}

__device__ __forceinline__ void unpack16(const unsigned char* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack16(const unsigned char* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

__device__ __forceinline__ float2 load_pair(const unsigned char* p, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const unsigned char* p, float) {
  return *reinterpret_cast<const float2*>(p);
}

// Scratch layout, float: acc of every (row, group, chunk) as [G][HD], then
// (m, l) of every (row, group, chunk) as [G][2].
__device__ __forceinline__ float* part_acc(float* part, int bkv, int nchunks, int c, int GH) {
  return part + ((size_t)bkv * nchunks + c) * GH;
}

__device__ __forceinline__ float* part_ml(float* part, int nbkv, int bkv, int nchunks, int c,
                                          int GH, int G) {
  return part + (size_t)nbkv * nchunks * GH + ((size_t)bkv * nchunks + c) * G * 2;
}

// GP: the group size G = H / KV rounded up to a power of two >= 2.  Rows
// G..GP-1 of q are zero and their results are dropped, so every loop over the
// group's rows has a compile-time trip count.
template <typename T, int HD, int GP, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(const T* __restrict__ q,            // (B, H, HD)
                    const T* __restrict__ k,            // dense (B, S, KV, HD) | paged (P, page, KV, HD)
                    const T* __restrict__ v,
                    const int* __restrict__ block_tables,  // paged: (B, PP)
                    const int* __restrict__ rows,          // dense: (B,) cache rows, or null
                    const int* __restrict__ lengths,       // (B,)
                    float* __restrict__ part,           // scratch, see part_acc / part_ml
                    int H, int KV, int S, int nrows, int page, int PP, float scale) {
  static_assert(HD % 32 == 0 && HD <= 2 * kThreads, "head_dim must be 32, 64 or 128");
  using R = Ring<T, HD>;
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte unit
  constexpr int kUnits = HD / kVec;         // 16-byte units per row
  constexpr int kCols = HD / 2;             // P V: column pairs ...
  constexpr int kGroups = kThreads / kCols; // ... times key groups = threads
  constexpr int kKeys = kTile / kGroups;    // keys per group and tile
  constexpr int kRows = GP / kHalves;       // score rows per thread
  static_assert(kGroups * HD <= kRedRow, "P V partials must fit the score buffer");
  static_assert(GP % kHalves == 0 && GP <= kMaxG, "GP must be a power of two in [2, 16]");
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + R::kBytes);  // [GP][HD]
  float* s_s = q_s + GP * HD;  // [GP][kRedRow]: scores, then p, then P V partials
  __shared__ size_t row_s[kChunk];  // cache row of each position of the chunk
  __shared__ float m_s[kMaxG], l_s[kMaxG];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, nchunks = gridDim.x;
  const int bkv = blockIdx.y, b = bkv / KV, kv = bkv % KV;
  const int cap = PAGED ? PP * page : S;
  // The dense cache holds nrows rows; query row b reads cache row rows[b]
  // (b when rows is null), so a pipeline stage decodes any subset of its
  // slots in place.  A row outside [0, nrows) reads row 0, as a negative
  // page reads page 0.  Loaded beside lengths[b], so the two global reads
  // overlap instead of adding a second round trip before the first copy.
  int crow = (!PAGED && rows != nullptr) ? rows[b] : b;
  int len = lengths[b];
  crow = (crow < 0 || crow >= nrows) ? 0 : crow;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int c0 = c * kChunk;
  if (c0 >= len) return;
  const int n = min(kChunk, len - c0);       // keys of this chunk
  const int ntiles = (n + kTile - 1) / kTile;
  const int nitems = 2 * ntiles;             // K tiles, then V tiles

  // The one place the two layouts differ: where position pos lives.
  for (int i = tid; i < n; i += kThreads) {
    const int pos = c0 + i;
    if (PAGED) {
      int pg = block_tables[(size_t)b * PP + pos / page];
      pg = pg < 0 ? 0 : pg;
      row_s[i] = ((size_t)pg * page + pos % page) * KV + kv;
    } else {
      row_s[i] = ((size_t)crow * S + pos) * KV + kv;
    }
  }
  __syncthreads();
  auto load = [&](int item) {
    const T* src = item < ntiles ? k : v;
    const int t0 = c0 + (item < ntiles ? item : item - ntiles) * kTile;
    unsigned char* dst = ring + (item & 1) * R::kStage;
    for (int i = tid; i < kTile * kUnits; i += kThreads) {
      const int r = i / kUnits, u = i % kUnits, pos = t0 + r;
      const bool ok = pos < c0 + n;
      const size_t row = ok ? row_s[pos - c0] : 0;
      cp_async_16(dst + r * R::kRow + u * 16, src + row * HD + u * kVec, ok);
    }
    cp_async_commit();
  };
  load(0);
  load(1);
  const T* qb = q + ((size_t)b * H + (size_t)kv * G) * HD;
  for (int i = tid; i < GP * HD; i += kThreads) q_s[i] = i < G * HD ? to_float(qb[i]) : 0.f;

  float acc[GP][2];
#pragma unroll
  for (int g = 0; g < GP; ++g) acc[g][0] = acc[g][1] = 0.f;
  const int cg = tid % kCols, kg = tid / kCols;
  const int key = tid % kTile, half = tid / kTile;

  for (int item = 0; item < nitems; ++item) {
    if (item + 1 < nitems) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // item landed; q_s, and p after the K tiles, visible
    const unsigned char* st = ring + (item & 1) * R::kStage;
    if (item < ntiles) {
      // Scores of key `key` of K tile `item` for query rows half, half + 2, ...
      float s[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = 0.f;
      const unsigned char* krow = st + key * R::kRow;
#pragma unroll 2
      for (int u = 0; u < kUnits; ++u) {
        float kx[kVec];
        unpack16(krow + u * 16, kx);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float* qr = q_s + (half + kHalves * i) * HD + u * kVec;
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            s[i] = fmaf(qv.x, kx[e], s[i]);
            s[i] = fmaf(qv.y, kx[e + 1], s[i]);
            s[i] = fmaf(qv.z, kx[e + 2], s[i]);
            s[i] = fmaf(qv.w, kx[e + 3], s[i]);
          }
        }
      }
      const int j = item * kTile + key;
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        s_s[(half + kHalves * i) * kRedRow + j] = j < n ? s[i] * scale : kNegInf;
    } else {
      // P V over V tile `item - ntiles`: columns 2cg, 2cg+1, keys of group kg.
      const int t = item - ntiles;
      const int j0 = kg * kKeys;
      const int jmax = min(kKeys, n - t * kTile - j0);
      for (int j = 0; j < jmax; ++j) {
        const float2 vv = load_pair(st + (j0 + j) * R::kRow + cg * 2 * sizeof(T), T());
        const float* prow = s_s + t * kTile + j0 + j;
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float p = prow[g * kRedRow];
          acc[g][0] = fmaf(p, vv.x, acc[g][0]);
          acc[g][1] = fmaf(p, vv.y, acc[g][1]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage (and, last, with p)
    if (item + 2 < nitems) load(item + 2);
    if (item == ntiles - 1) {
      // Softmax over the chunk's n scores: warp w takes rows w, w + 4, ...
      // (rows G..GP-1 keep their zero scores, which P V multiplies by V and
      // the final write drops)
      for (int g = warp; g < G; g += kWarps) {
        float* row = s_s + g * kRedRow;
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < kChunk / 32; ++i)
          if (lane + 32 * i < n) mx = fmaxf(mx, row[lane + 32 * i]);
        mx = warp_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kChunk / 32; ++i) {
          if (lane + 32 * i < n) {
            const float p = expf(row[lane + 32 * i] - mx);
            row[lane + 32 * i] = p;
            sum += p;
          }
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          m_s[g] = mx;
          l_s[g] = sum;
        }
      }
    }
  }

  // Sum the key groups' partials in group order, then write the chunk state.
  float* red = s_s;  // [kGroups][GP][HD]
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    red[(kg * GP + g) * HD + 2 * cg] = acc[g][0];
    red[(kg * GP + g) * HD + 2 * cg + 1] = acc[g][1];
  }
  __syncthreads();
  const int GH = G * HD;
  float* pa = part_acc(part, bkv, nchunks, c, GH);
  for (int i = tid; i < GH; i += kThreads) {
    float x = red[i];
#pragma unroll
    for (int grp = 1; grp < kGroups; ++grp) x += red[grp * GP * HD + i];
    pa[i] = x;
  }
  if (tid < G) {
    float* ml = part_ml(part, gridDim.y, bkv, nchunks, c, GH, G);
    ml[2 * tid] = m_s[tid];
    ml[2 * tid + 1] = l_s[tid];
  }
}

// One CTA per (row, KV group): merge the chunks in chunk order.  The (m, l)
// of every (chunk, row of the group) are staged in shared memory at once and
// turned into weights exp(m_c - max_c m_c) there, so the output loop reads
// only the partial accumulators, which are independent of one another.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(float* __restrict__ part, const int* __restrict__ lengths,
                      T* __restrict__ out,  // (B, H, HD)
                      int H, int KV, int HD, int cap, int nchunks) {
  extern __shared__ float w_s[];  // weights [nchunks][G], then l [nchunks][G], then L [G]
  const int bkv = blockIdx.x, b = bkv / KV, kv = bkv % KV;
  const int G = H / KV, GH = G * HD;
  float* l_s = w_s + nchunks * G;
  float* sum_s = l_s + nchunks * G;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int nc = (len + kChunk - 1) / kChunk;
  for (int p = threadIdx.x; p < nc * G; p += kThreads) {
    const float* ml = part_ml(part, gridDim.x, bkv, nchunks, p / G, GH, G) + 2 * (p % G);
    w_s[p] = ml[0];
    l_s[p] = ml[1];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float m = kNegInf;
    for (int c = 0; c < nc; ++c) m = fmaxf(m, w_s[c * G + g]);
    float l = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float w = expf(w_s[c * G + g] - m);
      w_s[c * G + g] = w;
      l = fmaf(l_s[c * G + g], w, l);
    }
    sum_s[g] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)kv * G) * HD;
  for (int i = threadIdx.x; i < GH; i += kThreads) {
    const int g = i / HD;
    float o = 0.f;
#pragma unroll 4
    for (int c = 0; c < nc; ++c)
      o = fmaf(part_acc(part, bkv, nchunks, c, GH)[i], w_s[c * G + g], o);
    ob[i] = from_float<T>(o / sum_s[g]);
  }
}

template <typename T, int HD, int GP, bool PAGED>
int launch_g(const T* q, const T* k, const T* v, const int* block_tables, const int* rows,
             const int* lengths, T* out, float* part, int B, int H, int KV, int S, int R,
             int page, int PP, cudaStream_t stream) {
  const int G = H / KV;
  constexpr size_t bytes = smem_bytes<T, HD, GP>();
  auto kernel = decode_chunk_kernel<T, HD, GP, PAGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int cap = PAGED ? PP * page : S;
  const int nchunks = (cap + kChunk - 1) / kChunk;
  kernel<<<dim3((unsigned)nchunks, (unsigned)(B * KV)), kThreads, bytes, stream>>>(
      q, k, v, block_tables, rows, lengths, part, H, KV, S, R, page, PP,
      1.0f / sqrtf((float)HD));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t cbytes = sizeof(float) * ((size_t)2 * nchunks * G + G);
  if (cbytes > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_combine_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cbytes);
    if (err != cudaSuccess) return (int)err;
  }
  decode_combine_kernel<T><<<(unsigned)(B * KV), kThreads, cbytes, stream>>>(
      part, lengths, out, H, KV, HD, cap, nchunks);
  return (int)cudaGetLastError();
}

template <typename T, int HD, bool PAGED>
int launch_hd(const T* q, const T* k, const T* v, const int* block_tables, const int* rows,
              const int* lengths, T* out, float* part, int B, int H, int KV, int S, int R,
              int page, int PP, cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 2)
    return launch_g<T, HD, 2, PAGED>(q, k, v, block_tables, rows, lengths, out, part, B, H,
                                     KV, S, R, page, PP, stream);
  if (G <= 4)
    return launch_g<T, HD, 4, PAGED>(q, k, v, block_tables, rows, lengths, out, part, B, H,
                                     KV, S, R, page, PP, stream);
  if (G <= 8)
    return launch_g<T, HD, 8, PAGED>(q, k, v, block_tables, rows, lengths, out, part, B, H,
                                     KV, S, R, page, PP, stream);
  return launch_g<T, HD, 16, PAGED>(q, k, v, block_tables, rows, lengths, out, part, B, H,
                                    KV, S, R, page, PP, stream);
}

template <typename T, bool PAGED>
int launch(const void* q, const void* k, const void* v, const int* block_tables,
           const int* rows, const int* lengths, void* out, void* scratch, int B, int H, int KV,
           int S, int R, int page, int PP, int hd, int chunk, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxG || B * KV > 65535 || chunk != kChunk)
    return (int)cudaErrorInvalidValue;
  if (PAGED ? (page <= 0 || PP <= 0) : (S <= 0 || R <= 0)) return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  float* part = static_cast<float*>(scratch);
  switch (hd) {
    case 32:
      return launch_hd<T, 32, PAGED>(qt, kt, vt, block_tables, rows, lengths, ot, part, B,
                                     H, KV, S, R, page, PP, stream);
    case 64:
      return launch_hd<T, 64, PAGED>(qt, kt, vt, block_tables, rows, lengths, ot, part, B,
                                     H, KV, S, R, page, PP, stream);
    case 128:
      return launch_hd<T, 128, PAGED>(qt, kt, vt, block_tables, rows, lengths, ot, part, B,
                                     H, KV, S, R, page, PP, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

extern "C" {

// Dense cache: q (B, H, hd); k, v (R, S, KV, hd); rows (B,) int32 cache row
// of each query row, or null for rows[b] = b (then R >= B); lengths (B,)
// int32.  scratch: B * KV * ceil(S / chunk) * (H / KV) * (hd + 2) floats;
// chunk must be the kernel's chunk (128).
int repro_decode_attention(const void* q, const void* k, const void* v, const int* rows,
                           const int* lengths, void* out, void* scratch, int B, int H, int KV,
                           int R, int S, int hd, int chunk, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float, false>(q, k, v, nullptr, rows, lengths, out, scratch, B, H, KV,
                                       S, R, 0, 0, hd, chunk, st);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16, false>(q, k, v, nullptr, rows, lengths, out, scratch,
                                               B, H, KV, S, R, 0, 0, hd, chunk, st);
  return (int)cudaErrorInvalidValue;
}

// Paged pool: q (B, H, hd); pools (P, page, KV, hd); block_tables (B, PP)
// int32 page ids (< 0 = unused); lengths (B,) int32; scratch as above with
// S = PP * page.
int repro_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                 const int* block_tables, const int* lengths, void* out,
                                 void* scratch, int B, int H, int KV, int page, int PP, int hd,
                                 int chunk, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float, true>(q, k_pool, v_pool, block_tables, nullptr, lengths, out,
                                      scratch, B, H, KV, 0, 0, page, PP, hd, chunk, st);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16, true>(q, k_pool, v_pool, block_tables, nullptr, lengths,
                                              out, scratch, B, H, KV, 0, 0, page, PP, hd, chunk,
                                              st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
