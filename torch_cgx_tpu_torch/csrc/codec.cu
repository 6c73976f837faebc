// Max-min codec kernels for Hopper (sm_90a): quantize, dequantize (with an
// optional fused add), the fused SRA epilogue, the multi-row reduce, the
// producer's matmul with a quantize epilogue, pipelined versions of the
// first three, and the quantize diagnostics of the kernel benchmark.
//
// They replace the Pallas TPU kernels of torch_cgx_tpu/ops/codec_pallas.py,
// torch_cgx_tpu/ops/fused_producer.py and tools/qbench.py:
//   cgx_quantize         <- _quantize_flat_impl (B1) and _quantize_chunks_impl (B5)
//   cgx_dequantize       <- _dequantize_flat_impl (B2) and _dequantize_chunks_impl (B6)
//   cgx_sra_epilogue     <- _sra_epilogue_impl (B3)
//   cgx_reduce_rows      <- _reduce_rows_impl (B4)
//   cgx_matmul_quantize  <- fused_producer.py _matmul_quantize_impl (B8)
//   cgx_quantize_db      <- _quantize_flat_db_impl (B7a)
//   cgx_dequantize_db    <- _dequantize_flat_db_impl (B7b)
//   cgx_sra_epilogue_db  <- _sra_epilogue_db_impl (B7c)
//   cgx_quantize_variant <- tools/qbench.py make_variant_kernel (B9: the
//                           nometa, metalane and read bodies; its mul and
//                           butterfly variants are cgx_quantize's lowerings)
// CUDA has no 128-lane tiling constraint, so one kernel serves both the flat
// and the bucket-row geometry of each TPU pair: every kernel walks whole
// chunks of 32 buckets, one thread block per chunk.
//
// Wire layout (torch_cgx_tpu/ops/codec.py): chunk c holds buckets
// 32c..32c+31; value (c, s, l) is x[c*32*B + s*B + l]; word (c, w, l) at
// c*bits*B + w*B + l packs bit w of the level at position l of each of the
// chunk's 32 buckets, bucket s in bit s; meta (c, s) is the pair
// (unit, min) at (c*32 + s)*2.
//
// Bound on an H100: the four codec kernels are memory-bound. For n values
// at `bits` bits and bucket B:
//   quantize   reads 4n bytes, writes n*bits/8 + 8n/B;
//   dequantize reads n*bits/8 + 8n/B (+ 4n with add), writes 4n;
//   epilogue   reads ws*(n*bits/8 + 8n/B) (+ 4n of raw own row), writes
//              n*bits/8 + 8n/B, n = the chunk's length;
//   reduce     reads the same, writes 4n.
// The operations per value (a divide, a handful of adds, shifts and ors)
// stay far below the card's rate for that traffic. The matmul-quantize is
// operation-bound: 2*K*din*o f32 operations for n = din*o values against
// 4*K*(din + o) bytes read and n*bits/8 + 8n/B written. The single-stage
// kernels are simple: coalesced global loads, neighbouring threads on
// neighbouring positions l of one bucket, one block per chunk. The
// pipelined (*_db) kernels keep one persistent block per SM slot and
// stream their inputs through a ring of shared-memory slots filled by bulk
// asynchronous copies (see their section below). No tensor cores.
//
// Arithmetic is fixed to the plain PyTorch version in
// torch_cgx_tpu_torch/ops/codec.py, bit for bit: the meta multiplies by
// f32(1/(2^bits-1)) computed on the host; levels use an IEEE divide (or,
// under the mul encode, a multiply by the bucket's correctly rounded
// reciprocal); decode rounds the product before the add. Explicit __f*_rn
// intrinsics keep nvcc from contracting a*b+c into an FMA (the build adds
// -fmad=false too).
//
// Two lowerings are template parameters of every quantizing kernel, so the
// default pair compiles to its own code with no branch in the inner loop:
//   ENCODE  kEncodeDiv: (x - min) / safe;  kEncodeMul: (x - min) * inv with
//           inv = 1 / safe once per bucket (CGX_CODEC_ENCODE=mul);
//   PACK    kPackSum: thread l ORs the 32 buckets' bits of position l into
//           its words; kPackButterfly (CGX_PALLAS_PACK=butterfly): lane s of
//           a warp holds bucket s, and each plane word is one __ballot_sync,
//           since the bit-plane wire layout is exactly a warp ballot.
// Both pairs give the same bytes for the same encode.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkBuckets = 32;
constexpr int kThreads = 256;

constexpr int kEncodeDiv = 0;
constexpr int kEncodeMul = 1;
constexpr int kPackSum = 0;
constexpr int kPackButterfly = 1;
constexpr int kMetaPairs = 0;  // chunk_meta stores the (unit, min) pairs
constexpr int kMetaNone = 1;   // chunk_meta leaves the meta store to its caller

// Per-bucket max/min of one chunk. src: 32 buckets of B floats (global or
// shared memory). Writes (unit, min) to shared memory (under the mul
// encode s_unit holds the reciprocal 1/safe instead, correctly rounded)
// and, with META == kMetaPairs, the pairs to meta_out.
template <int ENCODE = kEncodeDiv, int META = kMetaPairs>
__device__ void chunk_meta(const float* src, int B, float inv, float* s_unit,
                           float* s_min, float* meta_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int s = warp; s < kChunkBuckets; s += (int)(blockDim.x >> 5)) {
    const float* row = src + (size_t)s * B;
    float mx = row[lane];
    float mn = mx;
    for (int l = lane + 32; l < B; l += 32) {
      const float v = row[l];
      mx = v > mx ? v : mx;
      mn = v < mn ? v : mn;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float omx = __shfl_xor_sync(0xffffffffu, mx, o);
      const float omn = __shfl_xor_sync(0xffffffffu, mn, o);
      mx = omx > mx ? omx : mx;
      mn = omn < mn ? omn : mn;
    }
    if (lane == 0) {
      const float unit = __fmul_rn(__fsub_rn(mx, mn), inv);
      if (ENCODE == kEncodeMul) {
        s_unit[s] = __fdiv_rn(1.f, unit > 0.f ? unit : 1.f);
      } else {
        s_unit[s] = unit;
      }
      s_min[s] = mn;
      if (META == kMetaPairs) {
        meta_out[2 * s] = unit;
        meta_out[2 * s + 1] = mn;
      }
    }
  }
}

// The level of value x of a bucket whose chunk_meta entries are `scale`
// (the unit, or under the mul encode the reciprocal) and `bmin`.
template <int BITS, int ENCODE>
__device__ __forceinline__ uint32_t level_of(float x, float scale, float bmin) {
  const float maxlvl = (float)((1 << BITS) - 1);
  float y;
  if (ENCODE == kEncodeMul) {
    y = __fadd_rn(__fmul_rn(__fsub_rn(x, bmin), scale), 0.5f);
  } else {
    const float safe = scale > 0.f ? scale : 1.f;
    y = __fadd_rn(__fdiv_rn(__fsub_rn(x, bmin), safe), 0.5f);
  }
  return (uint32_t)fminf(fmaxf(floorf(y), 0.f), maxlvl);
}

// Levels of one chunk, packed as bit planes into words_out (BITS words of
// B at each position).
// kPackSum: thread l owns position l of all 32 buckets and ORs bit k of
// bucket s's level into word k at bit s.
// kPackButterfly: a warp takes 32 positions at a time. Lane j computes the
// levels of position l0 + j in all 32 buckets (coalesced reads), the warp
// transposes them through `stage`, then in turn for each position lane s
// holds bucket s's level and bit k of word k is one __ballot_sync. The
// stage is each warp's 32 x 32 words, rotated (level (s, j) at column
// (j + s) % 32 of row s) so that both the row-wise writes and the
// bucket-wise reads hit 32 distinct banks. STAGE_IN_TILE: the stage is the
// warp's own 32 columns of the (32, B) tile it just read (src, row stride
// B; nothing reads those columns again); otherwise a private buffer of
// blockDim.x * 32 words, 32 words a row.
template <int BITS, int ENCODE, int PACK, bool STAGE_IN_TILE = true>
__device__ void chunk_encode(const float* src, int B, const float* s_unit,
                             const float* s_min, int32_t* words_out,
                             uint32_t* stage = nullptr) {
  if (PACK == kPackButterfly) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int l0 = warp * 32; l0 < B; l0 += blockDim.x) {
      uint32_t* st = STAGE_IN_TILE ? reinterpret_cast<uint32_t*>(const_cast<float*>(src)) + l0
                                   : stage + (size_t)warp * 32 * 32;
      const int stride = STAGE_IN_TILE ? B : 32;
      uint32_t q[kChunkBuckets];
#pragma unroll
      for (int s = 0; s < kChunkBuckets; ++s) {
        q[s] = level_of<BITS, ENCODE>(src[(size_t)s * B + l0 + lane], s_unit[s], s_min[s]);
      }
      __syncwarp();  // every lane has read its column before the stage overwrites it
#pragma unroll
      for (int s = 0; s < kChunkBuckets; ++s) st[(size_t)s * stride + ((lane + s) & 31)] = q[s];
      __syncwarp();
      uint32_t w[BITS];
#pragma unroll
      for (int k = 0; k < BITS; ++k) w[k] = 0u;
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const uint32_t v = st[(size_t)lane * stride + ((j + lane) & 31)];  // bucket lane, position l0 + j
#pragma unroll
        for (int k = 0; k < BITS; ++k) {
          const uint32_t b = __ballot_sync(0xffffffffu, (v >> k) & 1u);
          w[k] = lane == j ? b : w[k];
        }
      }
#pragma unroll
      for (int k = 0; k < BITS; ++k) words_out[(size_t)k * B + l0 + lane] = (int32_t)w[k];
      __syncwarp();  // the stage's reads are done before the next group writes it
    }
    return;
  }
  for (int l = threadIdx.x; l < B; l += blockDim.x) {
    uint32_t w[BITS];
#pragma unroll
    for (int k = 0; k < BITS; ++k) w[k] = 0u;
#pragma unroll 4
    for (int s = 0; s < kChunkBuckets; ++s) {
      const uint32_t q = level_of<BITS, ENCODE>(src[(size_t)s * B + l], s_unit[s], s_min[s]);
#pragma unroll
      for (int k = 0; k < BITS; ++k) w[k] |= ((q >> k) & 1u) << s;
    }
#pragma unroll
    for (int k = 0; k < BITS; ++k) words_out[(size_t)k * B + l] = (int32_t)w[k];
  }
}

// Level of bucket s at one position from its BITS plane words, decoded as
// min + unit * level with the product rounded before the add.
template <int BITS>
__device__ __forceinline__ float decode_one(const uint32_t (&w)[BITS], int s,
                                            float unit, float bmin) {
  uint32_t q = 0u;
#pragma unroll
  for (int k = 0; k < BITS; ++k) q |= ((w[k] >> s) & 1u) << k;
  return __fadd_rn(bmin, __fmul_rn(unit, (float)q));
}

__device__ __forceinline__ void load_chunk_meta(const float* meta, float* s_unit,
                                                float* s_min) {
  if (threadIdx.x < kChunkBuckets) {
    s_unit[threadIdx.x] = meta[2 * threadIdx.x];
    s_min[threadIdx.x] = meta[2 * threadIdx.x + 1];
  }
}

// codec_quantize. Replaces codec_pallas.py _quantize_flat_impl (B1) and
// _quantize_chunks_impl (B5), and B9's mul and butterfly variants
// (tools/qbench.py). One block per chunk: warps reduce each bucket's
// max/min, then thread l encodes position l of all 32 buckets (under the
// butterfly pack, each warp 32 positions through a 32 KB private stage).
// Memory-bound: reads 4n bytes, writes n*bits/8 + 8n/B (n values, bucket B).
template <int BITS, int ENCODE, int PACK>
__global__ void __launch_bounds__(kThreads)
    cgx_quantize_kernel(const float* __restrict__ x, int32_t* __restrict__ words,
                        float* __restrict__ meta, int B, float inv) {
  __shared__ float s_unit[kChunkBuckets];
  __shared__ float s_min[kChunkBuckets];
  __shared__ uint32_t s_stage[PACK == kPackButterfly ? kThreads * 32 : 1];
  const size_t c = blockIdx.x;
  const float* src = x + c * kChunkBuckets * B;
  chunk_meta<ENCODE>(src, B, inv, s_unit, s_min, meta + c * 2 * kChunkBuckets);
  __syncthreads();
  chunk_encode<BITS, ENCODE, PACK, false>(src, B, s_unit, s_min, words + c * BITS * B, s_stage);
}

// codec_quantize_variant. Replaces tools/qbench.py make_variant_kernel
// (B9), the quantize diagnostics, on B1's geometry and chunk_meta:
//   kVariantNoMeta   B1's words, the meta zero-filled (the pairs' store
//                    dropped);
//   kVariantMetaLane B1's words, per chunk one 128-float meta row
//                    [32 units | 32 mins | 64 zeros] (a full-width store);
//   kVariantRead     per chunk, the int32 (toward zero, saturating, NaN ->
//                    0) of the largest unit of its 32 buckets in each of its
//                    bits*B words, and the usual meta: the input read and
//                    the output written with no encode and no pack.
// Memory-bound like B1: reads 4n bytes, writes n*bits/8 + 8n/B (metalane
// 16n/B of meta).
constexpr int kVariantNoMeta = 0;
constexpr int kVariantMetaLane = 1;
constexpr int kVariantRead = 2;

template <int BITS, int VARIANT>
__global__ void __launch_bounds__(kThreads)
    cgx_quantize_variant_kernel(const float* __restrict__ x, int32_t* __restrict__ words,
                                float* __restrict__ meta, int B, float inv) {
  __shared__ float s_unit[kChunkBuckets];
  __shared__ float s_min[kChunkBuckets];
  const size_t c = blockIdx.x;
  const float* src = x + c * kChunkBuckets * B;
  int32_t* wout = words + c * BITS * B;
  if (VARIANT == kVariantRead) {
    chunk_meta<kEncodeDiv, kMetaPairs>(src, B, inv, s_unit, s_min, meta + c * 2 * kChunkBuckets);
    __syncthreads();
    float m = s_unit[0];
    bool nan = false;
    for (int s = 0; s < kChunkBuckets; ++s) {
      const float u = s_unit[s];
      nan = nan || isnan(u);
      m = u > m ? u : m;
    }
    const int32_t v = nan ? 0 : __float2int_rz(m);
    for (int i = threadIdx.x; i < BITS * B; i += blockDim.x) wout[i] = v;
    return;
  }
  chunk_meta<kEncodeDiv, kMetaNone>(src, B, inv, s_unit, s_min, nullptr);
  __syncthreads();
  chunk_encode<BITS, kEncodeDiv, kPackSum>(src, B, s_unit, s_min, wout);
  const int t = threadIdx.x;
  if (VARIANT == kVariantNoMeta) {
    if (t < 2 * kChunkBuckets) meta[c * 2 * kChunkBuckets + t] = 0.f;
  } else if (t < 128) {
    meta[c * 128 + t] = t < kChunkBuckets ? s_unit[t] : t < 2 * kChunkBuckets ? s_min[t - kChunkBuckets] : 0.f;
  }
}

// codec_dequantize. Replaces codec_pallas.py _dequantize_flat_impl (B2,
// with its with_add fusion) and _dequantize_chunks_impl (B6). Thread l reads
// the bits words of position l and writes the 32 decoded values, adding the
// accumulator first when ADD. Memory-bound: reads n*bits/8 + 8n/B (+4n with
// ADD), writes 4n bytes.
template <int BITS, bool ADD>
__global__ void __launch_bounds__(kThreads)
    cgx_dequantize_kernel(const int32_t* __restrict__ words,
                          const float* __restrict__ meta,
                          const float* __restrict__ add, float* __restrict__ out,
                          int B) {
  __shared__ float s_unit[kChunkBuckets];
  __shared__ float s_min[kChunkBuckets];
  const size_t c = blockIdx.x;
  load_chunk_meta(meta + c * 2 * kChunkBuckets, s_unit, s_min);
  __syncthreads();
  const int32_t* wsrc = words + c * BITS * B;
  const size_t base = c * kChunkBuckets * B;
  for (int l = threadIdx.x; l < B; l += blockDim.x) {
    uint32_t w[BITS];
#pragma unroll
    for (int k = 0; k < BITS; ++k) w[k] = (uint32_t)wsrc[(size_t)k * B + l];
#pragma unroll 4
    for (int s = 0; s < kChunkBuckets; ++s) {
      const size_t i = base + (size_t)s * B + l;
      float v = decode_one<BITS>(w, s, s_unit[s], s_min[s]);
      if (ADD) v = __fadd_rn(add[i], v);
      out[i] = v;
    }
  }
}

// codec_sra_epilogue. Replaces codec_pallas.py _sra_epilogue_impl (B3).
// Memory-bound: reads ws*(n*bits/8 + 8n/B) (+4n of the raw own row), writes
// n*bits/8 + 8n/B; the reduced floats stay in shared memory.
// One block per chunk: decode the chunk of each of the ws rows (the raw own
// row in place of row `own`), fold them in ascending row order into a
// (32, B) f32 tile in shared memory, then requantize the tile with the same
// chunk_meta/chunk_encode the quantize kernel runs (the butterfly pack
// stages its levels in the tile's own columns).
template <int BITS, int ENCODE, int PACK>
__global__ void __launch_bounds__(kThreads)
    cgx_sra_epilogue_kernel(const int32_t* __restrict__ words,
                            const float* __restrict__ meta,
                            const float* __restrict__ raw, int own, int ws,
                            long long chunks, int B, float inv,
                            int32_t* __restrict__ out_words,
                            float* __restrict__ out_meta) {
  extern __shared__ float tile[];
  __shared__ float s_unit[kChunkBuckets];
  __shared__ float s_min[kChunkBuckets];
  const size_t c = blockIdx.x;
  const size_t row_words = (size_t)chunks * BITS * B;
  const size_t row_meta = (size_t)chunks * 2 * kChunkBuckets;
  for (int r = 0; r < ws; ++r) {
    __syncthreads();  // every thread is done with the previous row's meta
    load_chunk_meta(meta + r * row_meta + c * 2 * kChunkBuckets, s_unit, s_min);
    __syncthreads();
    const int32_t* wsrc = words + r * row_words + c * BITS * B;
    for (int l = threadIdx.x; l < B; l += blockDim.x) {
      uint32_t w[BITS];
#pragma unroll
      for (int k = 0; k < BITS; ++k) w[k] = (uint32_t)wsrc[(size_t)k * B + l];
#pragma unroll 4
      for (int s = 0; s < kChunkBuckets; ++s) {
        const float v =
            r == own ? raw[c * kChunkBuckets * B + (size_t)s * B + l]
                     : decode_one<BITS>(w, s, s_unit[s], s_min[s]);
        float* t = tile + (size_t)s * B + l;
        *t = r == 0 ? v : __fadd_rn(*t, v);
      }
    }
  }
  __syncthreads();
  chunk_meta<ENCODE>(tile, B, inv, s_unit, s_min, out_meta + c * 2 * kChunkBuckets);
  __syncthreads();
  chunk_encode<BITS, ENCODE, PACK>(tile, B, s_unit, s_min, out_words + c * BITS * B);
}

// codec_reduce_rows. Replaces codec_pallas.py _reduce_rows_impl (B4): the
// epilogue's decode-accumulate without the requantize. Memory-bound: reads
// ws*(n*bits/8 + 8n/B) (+4n of the raw own row), writes 4n bytes, n = the
// chunk's length. One block per chunk, the ws rows' meta staged in dynamic
// shared memory (ws*256 bytes); thread l keeps the 32 partial sums of
// position l in registers across the rows, folded in ascending row order
// (row 0's value, then + row 1, ...: dispatch.ordered_rowsum), and writes
// each reduced value once. No (32, B) tile, so no bucket-size limit.
template <int BITS>
__global__ void __launch_bounds__(kThreads)
    cgx_reduce_rows_kernel(const int32_t* __restrict__ words,
                           const float* __restrict__ meta,
                           const float* __restrict__ raw, int own, int ws,
                           long long chunks, int B, float* __restrict__ out) {
  extern __shared__ float s_meta[];  // [ws][32][2]: (unit, min)
  const size_t c = blockIdx.x;
  const size_t row_words = (size_t)chunks * BITS * B;
  const size_t row_meta = (size_t)chunks * 2 * kChunkBuckets;
  for (int i = threadIdx.x; i < ws * 2 * kChunkBuckets; i += blockDim.x) {
    const int r = i / (2 * kChunkBuckets);
    const int j = i % (2 * kChunkBuckets);
    s_meta[i] = meta[r * row_meta + c * 2 * kChunkBuckets + j];
  }
  __syncthreads();
  const size_t base = c * kChunkBuckets * B;
  for (int l = threadIdx.x; l < B; l += blockDim.x) {
    float acc[kChunkBuckets];
    for (int r = 0; r < ws; ++r) {
      const int32_t* wsrc = words + r * row_words + c * BITS * B;
      uint32_t w[BITS];
#pragma unroll
      for (int k = 0; k < BITS; ++k) w[k] = (uint32_t)wsrc[(size_t)k * B + l];
      const float* m = s_meta + r * 2 * kChunkBuckets;
#pragma unroll
      for (int s = 0; s < kChunkBuckets; ++s) {
        const float v = r == own ? raw[base + (size_t)s * B + l]
                                 : decode_one<BITS>(w, s, m[2 * s], m[2 * s + 1]);
        acc[s] = r == 0 ? v : __fadd_rn(acc[s], v);
      }
    }
#pragma unroll
    for (int s = 0; s < kChunkBuckets; ++s) out[base + (size_t)s * B + l] = acc[s];
  }
}

constexpr int kMmRows = 8;  // rows of dw one work item of the matmul covers
constexpr int kMmCols = 4;  // columns of dw one work item covers (a float4)
constexpr int kMmPanel = kThreads * kMmCols;  // columns of g2 one wave stages
constexpr int kMmMaxSteps = 8;  // contraction steps in one stage

// Asynchronous global -> shared copies (Ampere and later): the stage after
// the one being summed is in flight while the block computes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One work item's 8 x 4 sums: acc[rr][q] += x[rr] * g[q], k ascending.
__device__ __forceinline__ void mm_step(float (&acc)[kMmRows][kMmCols], const float* x,
                                        const float4 g) {
#pragma unroll
  for (int rr = 0; rr < kMmRows; ++rr) {
    const float xv = x[rr];
    acc[rr][0] = __fmaf_rn(xv, g.x, acc[rr][0]);
    acc[rr][1] = __fmaf_rn(xv, g.y, acc[rr][1]);
    acc[rr][2] = __fmaf_rn(xv, g.z, acc[rr][2]);
    acc[rr][3] = __fmaf_rn(xv, g.w, acc[rr][3]);
  }
}

// codec_matmul_quantize. Replaces fused_producer.py _matmul_quantize_impl
// (B8): dw = x2^T g2 (x2 f32 (K, din), g2 f32 (K, o), row-major), divided by
// div and quantized into the wire layout of the flat dw (din*o values, row
// major); the f32 dw is never written to global memory. Operation-bound:
// 2*K*din*o f32 operations; reads 4*K*(din + o) bytes at least once, writes
// n*bits/8 + 8n/B (n = din*o).
// One block per chunk of the flat dw (32 buckets, 32*B values, which may
// start and end inside a row). The block walks the rows the chunk touches
// in blocks of 8, and each row block in waves of 256 four-column groups:
// thread t owns the 8 x 4 values at column group t of the wave and keeps
// their sums in registers over the whole contraction, k ascending, one
// __fmaf_rn per product. With `steps` > 0 the block stages `steps` rows of
// g2 (the wave's columns) and of x2 (the row block's 8 values) in shared
// memory at a time, all threads copying, in two buffers: the next stage's
// copies (cp.async) are in flight while the block sums the current one.
// With `steps` == 0 (a bucket whose tile leaves no room) each thread reads
// its operands through the read-only cache. Either way the sums are the
// same. The values that fall inside the
// chunk, divided by div, go to a (32, B) f32 tile in shared memory, on
// which chunk_meta and chunk_encode run as in the epilogue, so the bytes
// equal the quantize kernel's for equal values.
template <int BITS, int ENCODE, int PACK>
__global__ void __launch_bounds__(kThreads)
    cgx_matmul_quantize_kernel(const float* __restrict__ x2,
                               const float* __restrict__ g2, long long k_total,
                               int din, int o, float div, int B, float inv, int steps,
                               int32_t* __restrict__ words,
                               float* __restrict__ meta) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_unit[kChunkBuckets];
  __shared__ float s_min[kChunkBuckets];
  const long long c = blockIdx.x;
  const long long chunk_n = (long long)kChunkBuckets * B;
  const long long base = c * chunk_n;
  float* tile = smem;
  float* g_s = smem + chunk_n;                      // 2 x steps x kMmPanel
  float* x_s = g_s + (size_t)2 * steps * kMmPanel;  // 2 x steps x kMmRows
  const int r_lo = (int)(base / o);
  const int r_hi = (int)((base + chunk_n - 1) / o);
  const int n_cg = o / kMmCols;
  for (int first = r_lo; first <= r_hi; first += kMmRows) {
    const int last = min(first + kMmRows - 1, r_hi);
    for (int cg0 = 0; cg0 < n_cg; cg0 += kThreads) {
      const int width = min(kThreads, n_cg - cg0);  // column groups in this wave
      const int col0 = cg0 * kMmCols;
      if ((long long)last * o + col0 + width * kMmCols <= base ||
          (long long)first * o + col0 >= base + chunk_n) {
        continue;  // none of the wave's values lies in this chunk
      }
      const int col = col0 + threadIdx.x * kMmCols;
      const bool mine = (int)threadIdx.x < width &&
                        (long long)last * o + col >= base &&
                        (long long)first * o + col < base + chunk_n;
      float acc[kMmRows][kMmCols];
#pragma unroll
      for (int rr = 0; rr < kMmRows; ++rr) {
#pragma unroll
        for (int q = 0; q < kMmCols; ++q) acc[rr][q] = 0.f;
      }
      if (steps > 0) {
        const long long n_stages = (k_total + steps - 1) / steps;
        // Copy stage s into buffer s % 2 (rows past `last` repeat row
        // `last`: their sums are never written).
        auto fetch = [&](long long st) {
          const long long k0 = st * steps;
          const int n_steps = (int)min((long long)steps, k_total - k0);
          float* gb = g_s + (size_t)(st & 1) * steps * kMmPanel;
          float* xb = x_s + (size_t)(st & 1) * steps * kMmRows;
          for (int i = threadIdx.x; i < n_steps * width; i += blockDim.x) {
            const int u = i / width, j = i % width;
            cp_async16(gb + (size_t)u * kMmPanel + j * kMmCols, g2 + (k0 + u) * o + col0 + j * kMmCols);
          }
          for (int i = threadIdx.x; i < n_steps * kMmRows; i += blockDim.x) {
            const int u = i / kMmRows, rr = i % kMmRows;
            cp_async4(xb + i, x2 + (k0 + u) * din + min(first + rr, last));
          }
          cp_async_commit();
        };
        __syncthreads();  // the previous wave is done with both buffers
        fetch(0);
        for (long long st = 0; st < n_stages; ++st) {
          if (st + 1 < n_stages) {
            fetch(st + 1);
          } else {
            cp_async_commit();  // an empty group keeps the wait below uniform
          }
          cp_async_wait_prior();  // this thread's copies of stage st landed
          __syncthreads();        // and everyone else's
          if (mine) {
            const int n_steps = (int)min((long long)steps, k_total - st * steps);
            const float* gb = g_s + (size_t)(st & 1) * steps * kMmPanel;
            const float* xb = x_s + (size_t)(st & 1) * steps * kMmRows;
#pragma unroll 4
            for (int u = 0; u < n_steps; ++u) {
              mm_step(acc, xb + u * kMmRows,
                      reinterpret_cast<const float4*>(gb + (size_t)u * kMmPanel)[threadIdx.x]);
            }
          }
          __syncthreads();  // buffer st % 2 is free for stage st + 2
        }
      } else if (mine) {
        for (long long k = 0; k < k_total; ++k) {
          float x[kMmRows];
#pragma unroll
          for (int rr = 0; rr < kMmRows; ++rr) {
            x[rr] = first + rr <= last ? __ldg(x2 + k * din + first + rr) : 0.f;
          }
          mm_step(acc, x, __ldg(reinterpret_cast<const float4*>(g2 + k * o + col)));
        }
      }
      if (mine) {
#pragma unroll
        for (int rr = 0; rr < kMmRows; ++rr) {
          const long long flat = (long long)(first + rr) * o + col;
          if (first + rr <= last && flat >= base && flat < base + chunk_n) {
            float* t = tile + (flat - base);
#pragma unroll
            for (int q = 0; q < kMmCols; ++q) t[q] = __fdiv_rn(acc[rr][q], div);
          }
        }
      }
    }
  }
  __syncthreads();
  chunk_meta<ENCODE>(tile, B, inv, s_unit, s_min, meta + c * 2 * kChunkBuckets);
  __syncthreads();
  chunk_encode<BITS, ENCODE, PACK>(tile, B, s_unit, s_min, words + c * BITS * B);
}

// ---------------------------------------------------------------------------
// Pipelined (DB) kernels. They replace the double-buffered manual-DMA
// lowerings of codec_pallas.py, which walk the blocks in one kernel
// invocation with a 2-slot VMEM scratch per stream:
//   cgx_quantize_db         <- _quantize_flat_db_impl (B7a)
//   cgx_dequantize_db       <- _dequantize_flat_db_impl (B7b)
//   cgx_sra_epilogue_db     <- _sra_epilogue_db_impl (B7c)
// Each computes what its single-stage sibling computes, with the same
// chunk_meta / chunk_encode / decode_one, so the bytes are identical.
//
// The shape all three share: a persistent grid of (blocks an SM holds at
// the kernel's shared memory) x (SMs) blocks; block b walks tiles b,
// b + gridDim.x, ... A tile is `tc` consecutive chunks. The inputs stream
// through a ring of slots in dynamic shared memory, each with one
// mbarrier: thread 0 issues 1-D bulk asynchronous copies
// (cp.async.bulk ... mbarrier::complete_tx::bytes) into a slot after
// announcing the bytes (mbarrier.arrive.expect_tx), every thread waits on
// the slot's phase, and the slot is refilled only after a __syncthreads()
// says every thread is done with it. So the copy of the next tiles runs
// while the block computes this one; outputs go from registers straight
// to device memory (coalesced: neighbouring threads own neighbouring
// positions l). Bulk copies need 16-byte aligned addresses and sizes in
// multiples of 16: every per-chunk stride (32*B*4, bits*B*4, 256 bytes of
// meta) is one for B % 32 == 0, and the wrapper checks the base pointers.
// All three stay memory-bound, with the bounds of their siblings.
// ---------------------------------------------------------------------------

constexpr int kDbThreads = 512;
constexpr int kRing = 2;      // slots of the quantize and dequantize rings
constexpr int kEpiRing = 4;   // slots of the epilogue ring (one peer row's tile each)
constexpr int kBarBytes = 128;  // the ring's mbarriers, padded so the slots stay aligned

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Announce `bytes` of bulk copies on the barrier and arrive (the phase
// completes when they have landed).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive with no copy: completes the phase of a slot that holds nothing.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0 initialises the ring's barriers; every thread sees them after.
__device__ __forceinline__ void ring_init(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Tiles of a block: blockIdx.x, blockIdx.x + gridDim.x, ... below `tiles`.
__device__ __forceinline__ long long block_tiles(long long tiles) {
  return (tiles - 1 - (long long)blockIdx.x) / gridDim.x + 1;
}

__device__ __forceinline__ long long tile_of(long long j) {
  return (long long)blockIdx.x + j * gridDim.x;
}

// codec_quantize_db. Replaces codec_pallas.py _quantize_flat_db_impl (B7a).
// A slot holds one tile: tc whole chunks of f32 (tc*32*B*4 bytes), since
// the meta needs each bucket whole and the encode all 32 buckets at each
// position. From the slot, chunk_meta then chunk_encode run, so the input
// is read from device memory once (the single-stage kernel reads it
// twice). Memory-bound: reads 4n bytes, writes n*bits/8 + 8n/B. The
// butterfly pack stages its levels in the slot's own chunk, which is not
// read again before the slot is refilled.
template <int BITS, int ENCODE, int PACK>
__global__ void __launch_bounds__(kDbThreads)
    cgx_quantize_db_kernel(const float* __restrict__ x, int32_t* __restrict__ words,
                           float* __restrict__ meta, long long tiles, int tc, int B,
                           float inv) {
  extern __shared__ __align__(128) unsigned char db_smem[];
  __shared__ float s_unit[kChunkBuckets];
  __shared__ float s_min[kChunkBuckets];
  uint64_t* full = reinterpret_cast<uint64_t*>(db_smem);
  float* ring = reinterpret_cast<float*>(db_smem + kBarBytes);
  const size_t chunk_n = (size_t)kChunkBuckets * B;
  const size_t slot_n = (size_t)tc * chunk_n;
  const uint32_t slot_bytes = (uint32_t)(slot_n * sizeof(float));
  const long long mine = block_tiles(tiles);
  auto fill = [&](long long j) {
    const int s = (int)(j % kRing);
    mbar_expect_tx(&full[s], slot_bytes);
    bulk_load(ring + s * slot_n, x + tile_of(j) * slot_n, slot_bytes, &full[s]);
  };
  ring_init(full, kRing);
  if (threadIdx.x == 0) {
    for (long long j = 0; j < mine && j < kRing; ++j) fill(j);
  }
  for (long long j = 0; j < mine; ++j) {
    const int s = (int)(j % kRing);
    mbar_wait(&full[s], (uint32_t)((j / kRing) & 1));
    const float* src = ring + s * slot_n;
    for (int k = 0; k < tc; ++k) {
      const long long c = tile_of(j) * tc + k;
      chunk_meta<ENCODE>(src + k * chunk_n, B, inv, s_unit, s_min, meta + c * 2 * kChunkBuckets);
      __syncthreads();
      chunk_encode<BITS, ENCODE, PACK>(src + k * chunk_n, B, s_unit, s_min, words + c * BITS * B);
      __syncthreads();  // every thread is done with the chunk and its meta
    }
    if (threadIdx.x == 0 && j + kRing < mine) fill(j + kRing);
  }
}

// codec_dequantize_db. Replaces codec_pallas.py _dequantize_flat_db_impl
// (B7b, with its with_add fusion). A slot holds one tile's words
// (tc*bits*B*4 bytes), meta (tc*256) and, with ADD, the accumulator
// (tc*32*B*4). Thread l decodes position l of the 32 buckets from the slot
// and stores the values (plus the accumulator first with ADD) from
// registers. Memory-bound: reads n*bits/8 + 8n/B (+4n with ADD), writes 4n.
template <int BITS, bool ADD>
__global__ void __launch_bounds__(kDbThreads)
    cgx_dequantize_db_kernel(const int32_t* __restrict__ words,
                             const float* __restrict__ meta, const float* __restrict__ add,
                             float* __restrict__ out, long long tiles, int tc, int B) {
  extern __shared__ __align__(128) unsigned char db_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(db_smem);
  const size_t chunk_n = (size_t)kChunkBuckets * B;
  const size_t w_n = (size_t)tc * BITS * B;         // int32 words of a tile
  const size_t m_n = (size_t)tc * 2 * kChunkBuckets;  // f32 meta of a tile
  const size_t a_n = ADD ? (size_t)tc * chunk_n : 0;  // f32 accumulator of a tile
  const size_t slot_n = w_n + m_n + a_n;              // 4-byte words a slot
  unsigned char* ring = db_smem + kBarBytes;
  const long long mine = block_tiles(tiles);
  auto slot = [&](int s) { return reinterpret_cast<uint32_t*>(ring) + s * slot_n; };
  auto fill = [&](long long j) {
    const int s = (int)(j % kRing);
    const long long t = tile_of(j);
    mbar_expect_tx(&full[s], (uint32_t)(slot_n * 4));
    bulk_load(slot(s), words + t * w_n, (uint32_t)(w_n * 4), &full[s]);
    bulk_load(slot(s) + w_n, meta + t * m_n, (uint32_t)(m_n * 4), &full[s]);
    if (ADD) bulk_load(slot(s) + w_n + m_n, add + t * a_n, (uint32_t)(a_n * 4), &full[s]);
  };
  ring_init(full, kRing);
  if (threadIdx.x == 0) {
    for (long long j = 0; j < mine && j < kRing; ++j) fill(j);
  }
  for (long long j = 0; j < mine; ++j) {
    const int s = (int)(j % kRing);
    mbar_wait(&full[s], (uint32_t)((j / kRing) & 1));
    const uint32_t* sw = slot(s);
    const float* sm = reinterpret_cast<const float*>(sw + w_n);
    const float* sa = reinterpret_cast<const float*>(sw + w_n + m_n);
    for (int k = 0; k < tc; ++k) {
      const size_t base = (size_t)(tile_of(j) * tc + k) * chunk_n;
      const uint32_t* wk = sw + (size_t)k * BITS * B;
      const float* mk = sm + k * 2 * kChunkBuckets;
      for (int l = threadIdx.x; l < B; l += blockDim.x) {
        uint32_t w[BITS];
#pragma unroll
        for (int b = 0; b < BITS; ++b) w[b] = wk[(size_t)b * B + l];
#pragma unroll 4
        for (int q = 0; q < kChunkBuckets; ++q) {
          float v = decode_one<BITS>(w, q, mk[2 * q], mk[2 * q + 1]);
          if (ADD) v = __fadd_rn(sa[(size_t)k * chunk_n + (size_t)q * B + l], v);
          out[base + (size_t)q * B + l] = v;
        }
      }
    }
    __syncthreads();  // every thread is done with the slot
    if (threadIdx.x == 0 && j + kRing < mine) fill(j + kRing);
  }
}

// codec_sra_epilogue_db. Replaces codec_pallas.py _sra_epilogue_db_impl
// (B7c). The TPU kernel stages all ws peer rows of a block in VMEM; here a
// ring slot holds ONE peer row's tile (tc*bits*B*4 bytes of words and
// tc*256 of meta), so the shared memory it needs does not grow with ws.
// The ring streams rows 0..ws-1 of tile t, then those of the block's next
// tile; each row folds into a (tc, 32, B) f32 tile in shared memory in
// ascending order, exactly as cgx_sra_epilogue_kernel folds. Row `own`
// holds no copy (its barrier is arrived at without bytes): the raw own row
// is read from device memory at its turn in the fold. After the last row,
// chunk_meta and chunk_encode requantize each chunk of the tile.
// Memory-bound: reads ws*(n*bits/8 + 8n/B) (+4n of the raw own row),
// writes n*bits/8 + 8n/B; the reduced floats stay in shared memory.
template <int BITS, int ENCODE, int PACK>
__global__ void __launch_bounds__(kDbThreads)
    cgx_sra_epilogue_db_kernel(const int32_t* __restrict__ words,
                               const float* __restrict__ meta, const float* __restrict__ raw,
                               int own, int ws, long long chunks, long long tiles, int tc,
                               int B, float inv, int32_t* __restrict__ out_words,
                               float* __restrict__ out_meta) {
  extern __shared__ __align__(128) unsigned char db_smem[];
  __shared__ float s_unit[kChunkBuckets];
  __shared__ float s_min[kChunkBuckets];
  uint64_t* full = reinterpret_cast<uint64_t*>(db_smem);
  const size_t chunk_n = (size_t)kChunkBuckets * B;
  const size_t w_n = (size_t)tc * BITS * B;
  const size_t m_n = (size_t)tc * 2 * kChunkBuckets;
  const size_t slot_n = w_n + m_n;
  uint32_t* ring = reinterpret_cast<uint32_t*>(db_smem + kBarBytes);
  float* tile = reinterpret_cast<float*>(ring + kEpiRing * slot_n);
  const size_t row_words = (size_t)chunks * BITS * B;
  const size_t row_meta = (size_t)chunks * 2 * kChunkBuckets;
  const long long items = block_tiles(tiles) * ws;  // (tile, row) pairs
  auto fill = [&](long long i) {
    const int s = (int)(i % kEpiRing);
    const int r = (int)(i % ws);
    if (r == own) {
      mbar_arrive(&full[s]);
      return;
    }
    const long long t = tile_of(i / ws);
    uint32_t* dst = ring + s * slot_n;
    mbar_expect_tx(&full[s], (uint32_t)(slot_n * 4));
    bulk_load(dst, words + r * row_words + t * w_n, (uint32_t)(w_n * 4), &full[s]);
    bulk_load(dst + w_n, meta + r * row_meta + t * m_n, (uint32_t)(m_n * 4), &full[s]);
  };
  ring_init(full, kEpiRing);
  if (threadIdx.x == 0) {
    for (long long i = 0; i < items && i < kEpiRing; ++i) fill(i);
  }
  for (long long i = 0; i < items; ++i) {
    const int s = (int)(i % kEpiRing);
    const int r = (int)(i % ws);
    const long long c0 = tile_of(i / ws) * tc;
    mbar_wait(&full[s], (uint32_t)((i / kEpiRing) & 1));
    const uint32_t* sw = ring + s * slot_n;
    const float* sm = reinterpret_cast<const float*>(sw + w_n);
    for (int k = 0; k < tc; ++k) {
      const uint32_t* wk = sw + (size_t)k * BITS * B;
      const float* mk = sm + k * 2 * kChunkBuckets;
      const float* rk = r == own ? raw + (size_t)(c0 + k) * chunk_n : nullptr;
      float* tk = tile + (size_t)k * chunk_n;
      for (int l = threadIdx.x; l < B; l += blockDim.x) {
        uint32_t w[BITS];
        if (r != own) {
#pragma unroll
          for (int b = 0; b < BITS; ++b) w[b] = wk[(size_t)b * B + l];
        }
#pragma unroll 4
        for (int q = 0; q < kChunkBuckets; ++q) {
          const float v = r == own ? rk[(size_t)q * B + l]
                                   : decode_one<BITS>(w, q, mk[2 * q], mk[2 * q + 1]);
          float* t = tk + (size_t)q * B + l;
          *t = r == 0 ? v : __fadd_rn(*t, v);
        }
      }
    }
    __syncthreads();  // every thread is done with the slot (and the tile's row)
    if (threadIdx.x == 0 && i + kEpiRing < items) fill(i + kEpiRing);
    if (r == ws - 1) {
      for (int k = 0; k < tc; ++k) {
        const size_t c = (size_t)(c0 + k);
        chunk_meta<ENCODE>(tile + (size_t)k * chunk_n, B, inv, s_unit, s_min,
                           out_meta + c * 2 * kChunkBuckets);
        __syncthreads();
        chunk_encode<BITS, ENCODE, PACK>(tile + (size_t)k * chunk_n, B, s_unit, s_min,
                                         out_words + c * BITS * B);
        __syncthreads();  // the tile and the meta are free for the next tile
      }
    }
  }
}

#define CGX_DISPATCH_BITS(bits, ...)        \
  switch (bits) {                           \
    case 1: { constexpr int BITS = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int BITS = 2; __VA_ARGS__; } break; \
    case 3: { constexpr int BITS = 3; __VA_ARGS__; } break; \
    case 4: { constexpr int BITS = 4; __VA_ARGS__; } break; \
    case 5: { constexpr int BITS = 5; __VA_ARGS__; } break; \
    case 6: { constexpr int BITS = 6; __VA_ARGS__; } break; \
    case 7: { constexpr int BITS = 7; __VA_ARGS__; } break; \
    case 8: { constexpr int BITS = 8; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;             \
  }

// The (encode, pack) lowering pair as the constants ENCODE and PACK.
#define CGX_DISPATCH_LOWERING(encode, pack, ...)                                              \
  if (encode == kEncodeDiv && pack == kPackSum) {                                             \
    constexpr int ENCODE = kEncodeDiv, PACK = kPackSum; __VA_ARGS__;                          \
  } else if (encode == kEncodeMul && pack == kPackSum) {                                      \
    constexpr int ENCODE = kEncodeMul, PACK = kPackSum; __VA_ARGS__;                          \
  } else if (encode == kEncodeDiv && pack == kPackButterfly) {                                \
    constexpr int ENCODE = kEncodeDiv, PACK = kPackButterfly; __VA_ARGS__;                    \
  } else if (encode == kEncodeMul && pack == kPackButterfly) {                                \
    constexpr int ENCODE = kEncodeMul, PACK = kPackButterfly; __VA_ARGS__;                    \
  } else {                                                                                    \
    return (int)cudaErrorInvalidValue;                                                        \
  }

// The persistent grid of a pipelined kernel at `smem` bytes of dynamic
// shared memory: as many blocks as the SMs hold at once, at most `tiles`.
template <typename Kernel>
cudaError_t db_grid(Kernel kernel, size_t smem, long long tiles, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDbThreads, smem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = (long long)per_sm * sms;
  *grid = (unsigned)(tiles < most ? tiles : most);
  return cudaSuccess;
}

bool db_geometry_ok(long long chunks, int tc, int B) {
  return chunks >= 1 && tc >= 1 && chunks % tc == 0 && B >= 32 && B % 32 == 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// The build compiles this file once per part (-DCGX_PART=0..5), the parts
// in parallel, and links them into one library; without CGX_PART it
// compiles every entry point.
#ifdef CGX_PART
#define CGX_IN_PART(k) (CGX_PART == (k))
#else
#define CGX_IN_PART(k) 1
#endif

extern "C" {

// Every quantizing entry point takes `encode` (0 div, 1 mul) and `pack`
// (0 sum, 1 butterfly).

#if CGX_IN_PART(0)
// x: chunks*32*B f32 -> words: chunks*bits*B int32, meta: chunks*32*2 f32.
int cgx_quantize(const float* x, int32_t* words, float* meta, long long chunks,
                 int B, int bits, float inv, int encode, int pack, void* stream) {
  if (chunks < 1 || B < 32 || B % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack,
      cgx_quantize_kernel<BITS, ENCODE, PACK><<<(unsigned)chunks, kThreads, 0, st>>>(
          x, words, meta, B, inv)));
  return (int)cudaGetLastError();
}
#endif

#if CGX_IN_PART(1)
// B9's bodies. x: chunks*32*B f32 -> words: chunks*bits*B int32; meta:
// chunks*32*2 f32 (variant 0 nometa, 2 read) or chunks*128 f32 (1 metalane).
int cgx_quantize_variant(const float* x, int32_t* words, float* meta, long long chunks,
                         int B, int bits, int variant, float inv, void* stream) {
  if (chunks < 1 || B < 32 || B % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case kVariantNoMeta:
      CGX_DISPATCH_BITS(bits, cgx_quantize_variant_kernel<BITS, kVariantNoMeta>
                              <<<(unsigned)chunks, kThreads, 0, st>>>(x, words, meta, B, inv));
      break;
    case kVariantMetaLane:
      CGX_DISPATCH_BITS(bits, cgx_quantize_variant_kernel<BITS, kVariantMetaLane>
                              <<<(unsigned)chunks, kThreads, 0, st>>>(x, words, meta, B, inv));
      break;
    case kVariantRead:
      CGX_DISPATCH_BITS(bits, cgx_quantize_variant_kernel<BITS, kVariantRead>
                              <<<(unsigned)chunks, kThreads, 0, st>>>(x, words, meta, B, inv));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#endif

#if CGX_IN_PART(1)
// words + meta -> out (chunks*32*B f32); add (same shape) or null.
int cgx_dequantize(const int32_t* words, const float* meta, const float* add,
                   float* out, long long chunks, int B, int bits, void* stream) {
  if (chunks < 1 || B < 32 || B % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (add) {
    CGX_DISPATCH_BITS(bits, cgx_dequantize_kernel<BITS, true><<<(unsigned)chunks, kThreads, 0, st>>>(
                                words, meta, add, out, B));
  } else {
    CGX_DISPATCH_BITS(bits, cgx_dequantize_kernel<BITS, false><<<(unsigned)chunks, kThreads, 0, st>>>(
                                words, meta, add, out, B));
  }
  return (int)cudaGetLastError();
}
#endif

#if CGX_IN_PART(2)
// words: ws rows of chunks*bits*B int32, meta: ws rows of chunks*32*2 f32,
// raw: the own row's chunks*32*B f32 (null with own == -1) -> the
// requantized reduced chunk: out_words chunks*bits*B, out_meta chunks*32*2.
int cgx_sra_epilogue(const int32_t* words, const float* meta, const float* raw,
                     int own, int ws, long long chunks, int B, int bits,
                     float inv, int encode, int pack, int32_t* out_words, float* out_meta,
                     void* stream) {
  if (chunks < 1 || ws < 1 || B < 32 || B % 32) return (int)cudaErrorInvalidValue;
  if ((raw == nullptr) != (own < 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)kChunkBuckets * B * sizeof(float);
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    cudaError_t e = cudaFuncSetAttribute(cgx_sra_epilogue_kernel<BITS, ENCODE, PACK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    cgx_sra_epilogue_kernel<BITS, ENCODE, PACK><<<(unsigned)chunks, kThreads, smem, st>>>(
        words, meta, raw, own, ws, chunks, B, inv, out_words, out_meta);
  }));
  return (int)cudaGetLastError();
}
#endif

#if CGX_IN_PART(1)
// words: ws rows of chunks*bits*B int32, meta: ws rows of chunks*32*2 f32,
// raw: the own row's chunks*32*B f32 (null with own == -1) -> out: the
// reduced chunk, chunks*32*B f32.
int cgx_reduce_rows(const int32_t* words, const float* meta, const float* raw,
                    int own, int ws, long long chunks, int B, int bits,
                    float* out, void* stream) {
  if (chunks < 1 || ws < 1 || B < 32 || B % 32) return (int)cudaErrorInvalidValue;
  if ((raw == nullptr) != (own < 0) || own >= ws) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)ws * 2 * kChunkBuckets * sizeof(float);
  CGX_DISPATCH_BITS(bits, {
    cudaError_t e = cudaFuncSetAttribute(cgx_reduce_rows_kernel<BITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    cgx_reduce_rows_kernel<BITS><<<(unsigned)chunks, kThreads, smem, st>>>(
        words, meta, raw, own, ws, chunks, B, out);
  });
  return (int)cudaGetLastError();
}
#endif

#if CGX_IN_PART(3)
// x2: k_total*din f32, g2: k_total*o f32 (row-major; g2 16-byte aligned) ->
// the flat dw = x2^T g2 / div quantized: words (din*o/(32*B))*bits*B int32,
// meta (din*o/B)*2 f32. din*o must be whole 32-bucket chunks, o % 4 == 0.
// The (32, B) tile takes 128*B bytes of shared memory; what the block may
// use beyond it stages up to 8 contraction steps of the operands, twice.
int cgx_matmul_quantize(const float* x2, const float* g2, long long k_total,
                        int din, int o, float div, int32_t* words, float* meta,
                        int B, int bits, float inv, int encode, int pack, void* stream) {
  const long long n = (long long)din * o;
  const long long chunk_n = (long long)kChunkBuckets * B;
  if (k_total < 1 || din < 1 || o < kMmCols || o % kMmCols || B < 32 || B % 32 ||
      n % chunk_n || ((uintptr_t)g2 & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  // Shared memory: the tile, the meta, and two stages of staged operands.
  // Prefer stages small enough that two blocks share an SM; else the most
  // the block's own limit leaves (none: the operands go through the cache).
  const long long fixed = 2 * kChunkBuckets * (long long)sizeof(float) + chunk_n * (long long)sizeof(float);
  const long long stage = 2LL * (kMmPanel + kMmRows) * (long long)sizeof(float);  // per step, both buffers
  if (fixed > optin) return (int)cudaErrorInvalidValue;
  long long fit = (optin / 2 - 1024 - fixed) / stage;
  if (fit < kMmMaxSteps / 2) fit = (optin - fixed) / stage;
  const int steps = (int)(fit < kMmMaxSteps ? fit : kMmMaxSteps);
  const long long chunks = n / chunk_n;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(chunk_n + 2LL * steps * (kMmPanel + kMmRows)) * sizeof(float);
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    e = cudaFuncSetAttribute(cgx_matmul_quantize_kernel<BITS, ENCODE, PACK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cgx_matmul_quantize_kernel<BITS, ENCODE, PACK><<<(unsigned)chunks, kThreads, smem, st>>>(
        x2, g2, k_total, din, o, div, B, inv, steps, words, meta);
  }));
  return (int)cudaGetLastError();
}
#endif

// The pipelined kernels take the arguments of their single-stage siblings
// and `tc`, the chunks a tile (a ring slot) holds; tc divides the chunk
// count, and every pointer is 16-byte aligned. Shared memory: a
// quantize slot is tc*32*B*4 bytes, a dequantize slot tc*(bits*B*4 + 256)
// (+ tc*32*B*4 with add), two slots each; the epilogue has four slots of
// tc*(bits*B*4 + 256) and the tc*32*B*4-byte tile.

#if CGX_IN_PART(4)
int cgx_quantize_db(const float* x, int32_t* words, float* meta, long long chunks, int tc,
                    int B, int bits, float inv, int encode, int pack, void* stream) {
  if (!db_geometry_ok(chunks, tc, B) || !aligned16(x)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = chunks / tc;
  const size_t smem = kBarBytes + (size_t)kRing * tc * kChunkBuckets * B * sizeof(float);
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    unsigned grid = 0;
    cudaError_t e = db_grid(cgx_quantize_db_kernel<BITS, ENCODE, PACK>, smem, tiles, &grid);
    if (e != cudaSuccess) return (int)e;
    cgx_quantize_db_kernel<BITS, ENCODE, PACK><<<grid, kDbThreads, smem, st>>>(
        x, words, meta, tiles, tc, B, inv);
  }));
  return (int)cudaGetLastError();
}
#endif

#if CGX_IN_PART(1)
int cgx_dequantize_db(const int32_t* words, const float* meta, const float* add, float* out,
                      long long chunks, int tc, int B, int bits, void* stream) {
  if (!db_geometry_ok(chunks, tc, B) || !aligned16(words) || !aligned16(meta) ||
      (add && !aligned16(add))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = chunks / tc;
  const size_t add_n = add ? (size_t)kChunkBuckets * B : 0;
  CGX_DISPATCH_BITS(bits, {
    const size_t smem =
        kBarBytes + (size_t)kRing * tc * ((size_t)BITS * B + 2 * kChunkBuckets + add_n) * 4;
    unsigned grid = 0;
    cudaError_t e;
    if (add) {
      e = db_grid(cgx_dequantize_db_kernel<BITS, true>, smem, tiles, &grid);
      if (e != cudaSuccess) return (int)e;
      cgx_dequantize_db_kernel<BITS, true><<<grid, kDbThreads, smem, st>>>(
          words, meta, add, out, tiles, tc, B);
    } else {
      e = db_grid(cgx_dequantize_db_kernel<BITS, false>, smem, tiles, &grid);
      if (e != cudaSuccess) return (int)e;
      cgx_dequantize_db_kernel<BITS, false><<<grid, kDbThreads, smem, st>>>(
          words, meta, add, out, tiles, tc, B);
    }
  });
  return (int)cudaGetLastError();
}
#endif

#if CGX_IN_PART(5)
int cgx_sra_epilogue_db(const int32_t* words, const float* meta, const float* raw, int own,
                        int ws, long long chunks, int tc, int B, int bits, float inv,
                        int encode, int pack, int32_t* out_words, float* out_meta,
                        void* stream) {
  if (!db_geometry_ok(chunks, tc, B) || ws < 1 || own >= ws) return (int)cudaErrorInvalidValue;
  if ((raw == nullptr) != (own < 0)) return (int)cudaErrorInvalidValue;
  if (!aligned16(words) || !aligned16(meta) || (raw && !aligned16(raw))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = chunks / tc;
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    const size_t smem = kBarBytes +
                        (size_t)kEpiRing * tc * ((size_t)BITS * B + 2 * kChunkBuckets) * 4 +
                        (size_t)tc * kChunkBuckets * B * sizeof(float);
    unsigned grid = 0;
    cudaError_t e = db_grid(cgx_sra_epilogue_db_kernel<BITS, ENCODE, PACK>, smem, tiles, &grid);
    if (e != cudaSuccess) return (int)e;
    cgx_sra_epilogue_db_kernel<BITS, ENCODE, PACK><<<grid, kDbThreads, smem, st>>>(
        words, meta, raw, own, ws, chunks, tiles, tc, B, inv, out_words, out_meta);
  }));
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
