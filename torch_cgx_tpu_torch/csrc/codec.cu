// Max-min codec kernels for Hopper (sm_90a): quantize, dequantize (with an
// optional fused add) and the fused SRA epilogue.
//
// They replace the Pallas TPU kernels of torch_cgx_tpu/ops/codec_pallas.py:
//   cgx_quantize      <- _quantize_flat_impl (B1) and _quantize_chunks_impl (B5)
//   cgx_dequantize    <- _dequantize_flat_impl (B2) and _dequantize_chunks_impl (B6)
//   cgx_sra_epilogue  <- _sra_epilogue_impl (B3)
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
// Bound on an H100: all three are memory-bound. For n values at `bits` bits
// and bucket B:
//   quantize   reads 4n bytes, writes n*bits/8 + 8n/B;
//   dequantize reads n*bits/8 + 8n/B (+ 4n with add), writes 4n;
//   epilogue   reads ws*(n*bits/8 + 8n/B) (+ 4n of raw own row), writes
//              n*bits/8 + 8n/B, n = the chunk's length.
// The operations per value (a divide, a handful of adds, shifts and ors)
// stay far below the card's rate for that traffic. These first versions
// are simple: coalesced global loads, neighbouring threads on neighbouring
// positions l of one bucket; no TMA, no pipelining.
//
// Arithmetic is fixed to the plain PyTorch version in
// torch_cgx_tpu_torch/ops/codec.py, bit for bit: the meta multiplies by
// f32(1/(2^bits-1)) computed on the host; levels use an IEEE divide; decode
// rounds the product before the add. Explicit __f*_rn intrinsics keep nvcc
// from contracting a*b+c into an FMA (the build adds -fmad=false too).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkBuckets = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Per-bucket max/min of one chunk. src: 32 buckets of B floats (global or
// shared memory). Writes (unit, min) to shared memory and to meta_out.
__device__ void chunk_meta(const float* src, int B, float inv, float* s_unit,
                           float* s_min, float* meta_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int s = warp; s < kChunkBuckets; s += kWarps) {
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
      s_unit[s] = unit;
      s_min[s] = mn;
      meta_out[2 * s] = unit;
      meta_out[2 * s + 1] = mn;
    }
  }
}

// Levels of one chunk, packed as bit planes: thread l owns position l of
// all 32 buckets and ORs bit k of bucket s's level into word k at bit s.
template <int BITS>
__device__ void chunk_encode(const float* src, int B, const float* s_unit,
                             const float* s_min, int32_t* words_out) {
  const float maxlvl = (float)((1 << BITS) - 1);
  for (int l = threadIdx.x; l < B; l += blockDim.x) {
    uint32_t w[BITS];
#pragma unroll
    for (int k = 0; k < BITS; ++k) w[k] = 0u;
#pragma unroll 4
    for (int s = 0; s < kChunkBuckets; ++s) {
      const float unit = s_unit[s];
      const float safe = unit > 0.f ? unit : 1.f;
      const float y = __fadd_rn(
          __fdiv_rn(__fsub_rn(src[(size_t)s * B + l], s_min[s]), safe), 0.5f);
      const float lv = fminf(fmaxf(floorf(y), 0.f), maxlvl);
      const uint32_t q = (uint32_t)lv;
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
// _quantize_chunks_impl (B5). One block per chunk: warps reduce each bucket's
// max/min, then thread l encodes position l of all 32 buckets. Memory-bound:
// reads 4n bytes, writes n*bits/8 + 8n/B (n values, bucket B).
template <int BITS>
__global__ void __launch_bounds__(kThreads)
    cgx_quantize_kernel(const float* __restrict__ x, int32_t* __restrict__ words,
                        float* __restrict__ meta, int B, float inv) {
  __shared__ float s_unit[kChunkBuckets];
  __shared__ float s_min[kChunkBuckets];
  const size_t c = blockIdx.x;
  const float* src = x + c * kChunkBuckets * B;
  chunk_meta(src, B, inv, s_unit, s_min, meta + c * 2 * kChunkBuckets);
  __syncthreads();
  chunk_encode<BITS>(src, B, s_unit, s_min, words + c * BITS * B);
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
// chunk_meta/chunk_encode the quantize kernel runs.
template <int BITS>
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
  chunk_meta(tile, B, inv, s_unit, s_min, out_meta + c * 2 * kChunkBuckets);
  __syncthreads();
  chunk_encode<BITS>(tile, B, s_unit, s_min, out_words + c * BITS * B);
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

}  // namespace

extern "C" {

// x: chunks*32*B f32 -> words: chunks*bits*B int32, meta: chunks*32*2 f32.
int cgx_quantize(const float* x, int32_t* words, float* meta, long long chunks,
                 int B, int bits, float inv, void* stream) {
  if (chunks < 1 || B < 32 || B % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CGX_DISPATCH_BITS(bits, cgx_quantize_kernel<BITS><<<(unsigned)chunks, kThreads, 0, st>>>(
                              x, words, meta, B, inv));
  return (int)cudaGetLastError();
}

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

// words: ws rows of chunks*bits*B int32, meta: ws rows of chunks*32*2 f32,
// raw: the own row's chunks*32*B f32 (null with own == -1) -> the
// requantized reduced chunk: out_words chunks*bits*B, out_meta chunks*32*2.
int cgx_sra_epilogue(const int32_t* words, const float* meta, const float* raw,
                     int own, int ws, long long chunks, int B, int bits,
                     float inv, int32_t* out_words, float* out_meta,
                     void* stream) {
  if (chunks < 1 || ws < 1 || B < 32 || B % 32) return (int)cudaErrorInvalidValue;
  if ((raw == nullptr) != (own < 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)kChunkBuckets * B * sizeof(float);
  CGX_DISPATCH_BITS(bits, {
    cudaError_t e = cudaFuncSetAttribute(cgx_sra_epilogue_kernel<BITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    cgx_sra_epilogue_kernel<BITS><<<(unsigned)chunks, kThreads, smem, st>>>(
        words, meta, raw, own, ws, chunks, B, inv, out_words, out_meta);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
