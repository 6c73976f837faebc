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
//   cgx_matmul_quantize  <- fused_producer.py _matmul_quantize_impl (B8;
//                           with cgx_matmul_quantize_tc for 16-bit and
//                           cgx_tf32_split + cgx_matmul_quantize_tf32 for
//                           float32 operands on the tensor cores)
//   cgx_quantize_db      <- _quantize_flat_db_impl (B7a)
//   cgx_dequantize_db    <- _dequantize_flat_db_impl (B7b)
//   cgx_sra_epilogue_db  <- _sra_epilogue_db_impl (B7c)
//   cgx_quantize_variant <- tools/qbench.py make_variant_kernel (B9: the
//                           nometa, metalane and read bodies; its mul and
//                           butterfly variants are cgx_quantize's lowerings)
// CUDA has no 128-lane tiling constraint, so one kernel serves both the flat
// and the bucket-row geometry of each TPU pair: every codec kernel works on
// whole chunks of 32 buckets. B1/B5 and B3 give each chunk a thread-block
// cluster whose threads hold the chunk's values in registers (see their
// section), B9 runs B1's cluster body with one store changed, and B7a and
// B7c walk the chunks with the same clusters on a persistent grid; the
// multi-row reduce (B4) spreads its grid over the values, 8 buckets of 4
// positions a thread; the others take one thread block per chunk (or,
// B7b, a tile of chunks). The matmul-quantize tiles its output instead, and
// its tiles complete the chunks through the L2 (see its section).
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
// 4*K*(din + o) bytes read and n*bits/8 + 8n/B (+ 4n/ws of the own raw
// row) written. The other single-stage codec kernels are simple: coalesced
// global loads, neighbouring threads on neighbouring positions l of one
// bucket, one block per chunk. The pipelined (*_db) kernels run persistent
// grids that stream their inputs through a ring of shared-memory slots
// filled by bulk asynchronous copies (see their section below). The
// matmul-quantize runs on the tensor cores (wgmma, fed by TMA): its bf16
// and f16 operands wherever TMA can describe them
// (cgx_matmul_quantize_tc_kernel), its float32 operands as split TF32,
// three tf32 products a step on the hi and lo planes a split-transpose
// pass writes first (cgx_tf32_split_kernel, then
// cgx_matmul_quantize_tf32_kernel); its FFMA kernel takes the 16-bit
// shapes TMA cannot describe, and any operands forced to it. No other
// kernel uses tensor cores.
//
// Arithmetic is fixed to the plain PyTorch version in
// torch_cgx_tpu_torch/ops/codec.py, bit for bit: the meta multiplies by
// f32(1/(2^bits-1)) computed on the host; levels use an IEEE divide (or,
// under the mul encode, a multiply by the bucket's correctly rounded
// reciprocal); decode rounds the product before the add. The cluster
// kernels reach the IEEE quotient through a reciprocal and one FMA
// correction where that is exact (div_quotient). Explicit __f*_rn
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
//
// Stochastic rounding (a third template parameter of B1/B5, B3, B7a and
// B7c, STOCH; their entry points take a flag and the seed, and the
// stochastic instances build in parts of their own) replaces the encode's
// 0.5 by an offset r in [0, 1): level = clamp(floor(__fadd_rn(q, r)), 0, 2^bits - 1),
// q as in the deterministic encode, the meta unchanged. r comes from
// Philox4x32-10 (Random123's philox4x32_R(10, ...)) in the counter layout
// of torch_cgx_tpu_torch/utils/prng.py, whose plain version the CPU and the
// card check these kernels against bit for bit:
//   key     the 64-bit seed as two 32-bit words (high, low), a kernel
//           argument;
//   counter (l, c mod 2^32, (c >> 32) mod 2^16 | tag << 16, g): position l
//           in the bucket, chunk index c (row-major over the launch's rows;
//           for an epilogue its output row), tag 0 (the dense tail outside
//           the kernels draws with tag 1), bucket group g = s / 4;
//   output  word j rounds bucket 4g + j, as r = (word >> 8) * 2^-24, the
//           TPU kernels' conversion.
// So a value's offset depends only on the seed, the chunk, the bucket and
// the position: the cluster size, REREAD, the tile, the ring depth, the
// pack and which of B1/B7a or B3/B7c ran leave the bytes alone. A thread
// draws where it encodes, one Philox call a group of four buckets (eight
// calls for its position of the chunk's 32 buckets), so no array of 32
// offsets is live beside the 32 values. What bounds it: Philox-10 is 10
// rounds of two 32x32 -> 64-bit multiplies (on the FMA pipe; nvcc emits
// most as IMAD.HI and IMAD) and two three-way XORs (LOP3, on the integer
// ALU); the key bumps depend on the seed alone and run once a thread on
// the uniform path. A value issues about 15 instructions (about 7 on the
// FMA pipe, 6 on the ALU; chip_smoke.philox_sass reads them from the
// build's SASS): at 4 bits and B = 512 less than B1's bytes, more than
// the epilogue's, which are only the packed rows. The stochastic
// instances keep the deterministic ones' registers (64 a thread in the
// body) and spills (PERF.md, section 6).
//
// Wire dtypes (the JAX package syncs a bf16 or f16 leaf in its own dtype,
// parallel/allreduce.py): B1/B5 and B7a read their input, and B3, B7c and
// B4 their raw own row, as float32 or as a 16-bit float, and upcast each
// value exactly in registers (codec_pallas.py _quantize_kernel,
// _quantize_flat_kernel and _raw4_cast read the tensor's dtype inside the
// kernel). B3 and B7c round each folded value through the wire dtype
// (round to nearest even) before the meta and the levels, where the TPU
// kernels call _requant_cast: the staged path quantizes
// reduced.astype(x.dtype). The meta, levels and outputs stay f32; the
// decode side (B2/B6, B7b) stays f32 throughout, its callers upcast the
// meta and the accumulator, as the JAX package's do (codec.batch_views).
// The stored element is a template parameter E: float, or uint16_t for
// both 16-bit formats, whose format (bf16 or f16) is the launch's `wire`
// argument, uniform across the grid, so one set of 16-bit instances
// serves both. The f32 instances take `wire` last and never read it: their
// code is the one they had before the 16-bit instances existed. A 16-bit
// value costs an integer shift (bf16) or a convert (f16) beside a load of
// half the bytes; the round trip of B3/B7c two converts a value.
//
// The int8 fold (CGX_SRA_ACCUM=int8; codec_pallas.py _decode_accumulate,
// accum="int8"): B3, B7c and B4 take a last template parameter ACCUM,
// kAccumExact (the f32 fold above, whose instances keep their code) or
// kAccumInt8, whose instances build into a library of their own
// (CGX_INT8, below). Per bucket of a chunk, over its ws rows (the own
// row's meta included, its words never read):
//   U     the rows' largest unit, NaN-propagating (jnp.maximum);
//   usafe U > 0 ? U : 1, inv = 2^12 / usafe (IEEE divide);
//   s_r   rint(unit_r * inv) as int32, saturating, NaN -> 0 (XLA's
//         f32 -> s32 convert, cvt.rni.s32.f32); 0 for the own row;
//   bsum  +0, then + min_r (+0 for the own row) for every row ascending;
// and per value acc_i = sum over rows of level_r * s_r in int32 (wrapping),
// one integer multiply-add a row, the level decoded as an integer; then
// bsum + (usafe * 2^-12) * float(acc_i), the product rounded before the
// add, and the raw own row added last. A per-chunk prologue (one lane a
// bucket) writes s_r, bsum and usafe * 2^-12 beside the staged meta.

#include <cuda.h>  // CUtensorMap and its encoder's types (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace {

constexpr int kChunkBuckets = 32;
constexpr int kThreads = 256;

constexpr int kEncodeDiv = 0;
constexpr int kEncodeMul = 1;
constexpr int kPackSum = 0;
constexpr int kPackButterfly = 1;

// The wire dtypes by the entry points' `wire` argument
// (codec_cuda.WIRE_DTYPES).
constexpr int kWireF32 = 0;
constexpr int kWireBf16 = 1;
constexpr int kWireF16 = 2;

// A wire value as the exact float: E = float as it is; E = uint16_t the
// bits of a bf16 (`wire` kWireBf16: the bits are a float's upper half) or
// an f16 (kWireF16).
__device__ __forceinline__ float wire_float(float x, int) { return x; }
__device__ __forceinline__ float wire_float(uint16_t u, int wire) {
  return wire == kWireF16 ? __half2float(__ushort_as_half(u)) : __uint_as_float((uint32_t)u << 16);
}

// One wire value from global memory through the read-only path.
__device__ __forceinline__ float wire_ldg(const float* p, int) { return __ldg(p); }
__device__ __forceinline__ float wire_ldg(const uint16_t* p, int wire) {
  return wire_float(__ldg(reinterpret_cast<const unsigned short*>(p)), wire);
}

// x rounded to the nearest value of the wire dtype (ties to even; NaN
// stays NaN, the range's overflow inf), as a float: torch's and XLA's
// .to(dtype).to(float32). E = float: x itself.
template <typename E>
__device__ __forceinline__ float wire_round(float x, int wire) {
  if constexpr (sizeof(E) == 2) {
    return wire == kWireF16 ? __half2float(__float2half_rn(x))
                            : __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// Max and min that propagate NaN, as torch.amax / amin (and jnp.max / min)
// do: a bucket holding a NaN has a NaN max and min.
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || isnan(b)) ? b : a; }
__device__ __forceinline__ float nan_min(float a, float b) { return (b < a || isnan(b)) ? b : a; }

// The reduce kernels' fold (ACCUM): f32, or the int8 fold's level domain.
constexpr int kAccumExact = 0;
constexpr int kAccumInt8 = 1;
constexpr float kInt8One = 4096.f;  // 2^12: the unit scales' fixed-point one

// The int8 fold's parameters of one bucket of a chunk (see the head of this
// file), from its ws rows' pairs: unit at meta[r * stride], min at
// meta[r * stride + 1]; own: the raw row's index, or -1. Returns (inv,
// bsum, usafe * 2^-12, -).
__device__ __forceinline__ float4 int8_bucket(const float* meta, size_t stride, int ws, int own) {
  float U = meta[0];
  for (int r = 1; r < ws; ++r) U = nan_max(U, meta[(size_t)r * stride]);
  const float usafe = U > 0.f ? U : 1.f;
  float bsum = 0.f;
  for (int r = 0; r < ws; ++r) bsum = __fadd_rn(bsum, r != own ? meta[(size_t)r * stride + 1] : 0.f);
  return make_float4(__fdiv_rn(kInt8One, usafe), bsum, __fmul_rn(usafe, 1.f / kInt8One), 0.f);
}

// A kept row's scale s_r of a bucket from its unit and the bucket's inv.
__device__ __forceinline__ uint32_t int8_scale(float unit, float inv) {
  return (uint32_t)__float2int_rn(__fmul_rn(unit, inv));
}

// The int8 fold's parameters of a chunk in shared memory: par[s] bucket
// s's int8_bucket, scale[r * 32 + s] row r's s_r (0 for the own row).
// One lane a bucket (warp 0); the caller makes them visible.
__device__ __forceinline__ void int8_prologue(const float* meta, size_t stride, int ws, int own,
                                              float4* par, uint32_t* scale) {
  const int s = threadIdx.x;
  const float4 p = int8_bucket(meta + 2 * s, stride, ws, own);
  par[s] = p;
  for (int r = 0; r < ws; ++r) {
    scale[r * kChunkBuckets + s] = r != own ? int8_scale(meta[(size_t)r * stride + 2 * s], p.x) : 0u;
  }
}

// A folded value of the int8 fold: bsum + step * float(acc_i), the product
// rounded before the add.
__device__ __forceinline__ float int8_value(float4 par, uint32_t acc_i) {
  return __fadd_rn(par.y, __fmul_rn(par.z, __int2float_rn((int)acc_i)));
}

// Per-bucket max/min of one chunk. src: 32 buckets of B floats (global or
// shared memory). Writes (unit, min) to shared memory (under the mul
// encode s_unit holds the reciprocal 1/safe instead, correctly rounded)
// and the pairs to meta_out.
template <int ENCODE = kEncodeDiv>
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
      mx = nan_max(mx, v);
      mn = nan_min(mn, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (lane == 0) {
      const float unit = __fmul_rn(__fsub_rn(mx, mn), inv);
      if (ENCODE == kEncodeMul) {
        s_unit[s] = __fdiv_rn(1.f, unit > 0.f ? unit : 1.f);
      } else {
        s_unit[s] = unit;
      }
      s_min[s] = mn;
      meta_out[2 * s] = unit;
      meta_out[2 * s + 1] = mn;
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
// bucket-wise reads hit 32 distinct banks. The stage is the warp's own 32
// columns of the (32, B) shared-memory tile it just read (src, row stride
// B; nothing reads those columns again).
template <int BITS, int ENCODE, int PACK>
__device__ void chunk_encode(const float* src, int B, const float* s_unit,
                             const float* s_min, int32_t* words_out) {
  if (PACK == kPackButterfly) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int l0 = warp * 32; l0 < B; l0 += blockDim.x) {
      uint32_t* st = reinterpret_cast<uint32_t*>(const_cast<float*>(src)) + l0;
      const int stride = B;
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

// Asynchronous global -> shared copies (Ampere and later) with zero fill:
// the src_bytes first bytes come from src, the rest of the copy is zeros
// (src_bytes 0: nothing is read). The 16-byte form (.cg) reads through the
// L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The multi-row reduce (B4).
// ---------------------------------------------------------------------------
//
// codec_reduce_rows. Replaces codec_pallas.py _reduce_rows_impl (B4): the
// epilogue's decode-accumulate without the requantize. Memory-bound: reads
// the payload of every row but the own one (n*bits/8 + 8n/B each) and the
// raw own row (4n, or 2n in a 16-bit wire dtype: E, upcast as it is
// loaded), writes 4n bytes of f32, n = the reduced chunk's length.
//
// The grid covers values, not chunks. A thread takes VEC consecutive
// positions l..l+VEC-1 of a group of kReduceBuckets = 8 buckets 8g..8g+7 of
// one chunk and keeps their 8*VEC partial sums in registers across the
// rows; the four lanes 4p..4p+3 of a warp take the four groups of position
// vector p. A block of 128 threads covers P = 32*VEC positions of one
// chunk (4 blocks a chunk at B = 512 and VEC = 4). The meta is given, so
// the buckets need no cooperation: no cluster, no bucket-size limit.
//
// The one-block-a-chunk kernel this replaces walked its positions and its
// runtime-length row loop with the raw row's loads behind an r == own
// select: a chain of dependent loads a thread. Here every load of a stage
// is in flight before the first use. A thread loads its raw own row values
// into registers (VEC-wide, streaming), then the block's warps issue the
// stage's plane words of its positions and their meta as asynchronous
// global -> shared copies (VEC*4 bytes each, no register held while they
// fly, each word copied once though four lanes decode it); one wait and one
// barrier later the threads fold from shared memory and write each reduced
// value once (VEC-wide). The own row's words and meta are not read. The row
// count (1..8; 0 = any count, in stages of 8 rows) and the raw row's
// presence are template parameters, so a launch without the raw row keeps
// no register for it. Static shared memory, at most 34,816 bytes (8 rows of
// 8 planes), so no function attribute. VEC = 4 needs every operand 16-byte
// aligned (a 16-bit raw row: 8-byte, four values, the same element count)
// and B a multiple of 128; VEC = 1 is the same kernel at scalar
// width, for a raw row view that is not aligned (or a bucket the fused
// path's gate never admits), built at the any-count instance alone.
//
// Decode: a position's plane bytes of the thread's 8 buckets are gathered
// into one word (byte k = plane k: three byte permutes) and transposed by
// two delta swaps, so that bucket j's level sits in nibble reduce_nibble(j)
// (a second word holds planes 4..7 when BITS > 4): about 1.4 integer
// operations a value, where extracting each bit took 2 a bit. The level
// becomes a float exactly through the magic 2^23 (no I2F, which the card
// runs at a fraction of its float rate). Arithmetic as before, bit for
// bit: min + unit*level with the product rounded before the add, the rows
// folded in ascending order from row 0's value (acc = v0; acc += v1; ...:
// dispatch.ordered_rowsum), the raw row in place of row own's decode.

constexpr int kReduceBuckets = 8;                              // buckets a thread
constexpr int kReduceGroups = kChunkBuckets / kReduceBuckets;  // lanes sharing positions
constexpr int kReduceThreads = 128;
constexpr int kReduceVectors = kReduceThreads / kReduceGroups;  // position vectors a block
constexpr int kReduceWarps = kReduceThreads / 32;
constexpr int kReduceStageRows = 8;  // rows staged at once (the templated counts' ceiling)

// The nibble of level_nibbles' result that holds bucket j of the 8.
__host__ __device__ constexpr int reduce_nibble(int j) {
  return ((j >> 1) & 1) * 4 + (j & 1) * 2 + (j >> 2);
}

// Bucket j's level bits from byte `sel` picks of four plane words p0..p3
// (the 8 buckets of one byte, bucket j in bit j), as nibble
// reduce_nibble(j), bit k from plane k. The bytes are gathered into x (byte
// k = plane k: bit 8k + j), then bits 0 <-> 3 and 1 <-> 4 of the 5-bit bit
// index are swapped (two delta swaps), which moves bit (k, j) to 16*(j>>1&1)
// + 8*(j&1) + 4*(j>>2) + k.
__device__ __forceinline__ uint32_t level_nibbles(uint32_t p0, uint32_t p1, uint32_t p2,
                                                  uint32_t p3, uint32_t sel) {
  uint32_t x = __byte_perm(__byte_perm(p0, p1, sel), __byte_perm(p2, p3, sel), 0x5410);
  uint32_t t = (x ^ (x >> 7)) & 0x00AA00AAu;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCCu;
  return x ^ t ^ (t << 14);
}

// The level of bucket j (of the 8) as an exact float, from level_nibbles'
// word of planes 0..3 (lo) and, for BITS > 4, of planes 4..7 (hi).
template <int BITS>
__device__ __forceinline__ float nibble_level(uint32_t lo, uint32_t hi, int j) {
  const int n = reduce_nibble(j);
  if (BITS <= 4) {
    // Nibble m <= 4 of a mantissa under the exponent of 2^23: 2^23 +
    // q*16^m exactly, less 2^23, times 16^-m, both exact. One integer
    // operation a value (nibbles 5..7 from lo >> 12, shared by three).
    const int m = n < 5 ? n : n - 3;
    const uint32_t bits = ((n < 5 ? lo : lo >> 12) & (0xFu << (4 * m))) | 0x4B000000u;
    const float level = __fsub_rn(__uint_as_float(bits), 8388608.f);
    return m > 0 ? __fmul_rn(level, 1.f / (float)(1 << (4 * m))) : level;
  }
  const uint32_t q = ((lo >> (4 * n)) & 0xFu) | ((hi >> (4 * n)) & 0xFu) << 4;
  return __fsub_rn(__uint_as_float(q | 0x4B000000u), 8388608.f);  // 2^23 + q, less 2^23
}

// The level of bucket j (of the 8) as an integer (the int8 fold), from
// level_nibbles' words as nibble_level reads them.
template <int BITS>
__device__ __forceinline__ uint32_t nibble_level_int(uint32_t lo, uint32_t hi, int j) {
  const int n = reduce_nibble(j);
  const uint32_t q = (lo >> (4 * n)) & 0xFu;
  return BITS > 4 ? q | ((hi >> (4 * n)) & 0xFu) << 4 : q;
}

// VEC consecutive 4-byte values from global to shared memory, asynchronously
// (16-byte aligned when VEC == 4).
template <int VEC>
__device__ __forceinline__ void cp_async_vec(void* dst, const void* src) {
  if constexpr (VEC == 4) {
    cp_async16(dst, src, 16);
  } else {
    cp_async4(dst, src, 4);
  }
}

// VEC consecutive values (VEC == 4: 4 * sizeof(E) bytes, so aligned): from
// global memory, read once (streaming), the 16-bit ones upcast exactly; or
// from shared memory.
template <int VEC>
__device__ __forceinline__ void ld_stream(const float* p, float (&v)[VEC], int) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldcs(p);
  }
}
template <int VEC>
__device__ __forceinline__ void ld_stream(const uint16_t* p, float (&v)[VEC], int wire) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = wire_float((uint16_t)(t.x & 0xffffu), wire);
    v[1] = wire_float((uint16_t)(t.x >> 16), wire);
    v[2] = wire_float((uint16_t)(t.y & 0xffffu), wire);
    v[3] = wire_float((uint16_t)(t.y >> 16), wire);
  } else {
    v[0] = wire_float((uint16_t)__ldcs(reinterpret_cast<const unsigned short*>(p)), wire);
  }
}
template <int VEC>
__device__ __forceinline__ void lds_vec(const uint32_t* p, uint32_t (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int BITS, int ROWS, int VEC, bool RAW, typename E, int ACCUM = kAccumExact>
__global__ void __launch_bounds__(kReduceThreads)
    cgx_reduce_rows_kernel(const int32_t* __restrict__ words, const float* __restrict__ meta,
                           const E* __restrict__ raw, int own, int ws, long long chunks,
                           int B, float* __restrict__ out, int wire) {
  constexpr int G = kReduceBuckets;
  constexpr int STAGE = ROWS > 0 ? ROWS : kReduceStageRows;
  constexpr int P = kReduceVectors * VEC;  // positions a block
  __shared__ __align__(16) float s_meta[STAGE][2 * kChunkBuckets];
  __shared__ __align__(16) uint32_t s_words[STAGE * BITS][P];
  const int rows = ROWS > 0 ? ROWS : ws;
  const int blocks_per_chunk = B / P;
  const int part = (int)(blockIdx.x % (unsigned)blocks_per_chunk);
  const size_t c = blockIdx.x / (unsigned)blocks_per_chunk;
  const int warp = (int)threadIdx.x / 32, lane = (int)threadIdx.x % 32;
  const int g = (int)threadIdx.x % kReduceGroups;
  const int pv = (int)threadIdx.x / kReduceGroups;
  const int l0 = part * P;  // the block's first position
  const uint32_t sel = (uint32_t)g | (uint32_t)(g + 4) << 4;  // byte g of two words
  const size_t row_words = (size_t)chunks * BITS * B;
  const size_t row_meta = (size_t)chunks * 2 * kChunkBuckets;
  const size_t base = (c * kChunkBuckets + (size_t)G * g) * B + l0 + pv * VEC;  // value (c, 8g, l)

  float raw_v[G][VEC];
  if constexpr (RAW) {
#pragma unroll
    for (int j = 0; j < G; ++j) ld_stream<VEC>(raw + base + (size_t)j * B, raw_v[j], wire);
  }
  float acc[G][VEC];
  // The int8 fold: the chunk's bucket parameters from every row's meta
  // (the own row's unit too), made visible by the first stage's barrier;
  // each row's s_r from its staged unit where it is folded.
  constexpr bool INT8 = ACCUM == kAccumInt8;
  uint32_t acc_i[G][VEC];
  const float4* i8 = nullptr;
  if constexpr (INT8) {
    __shared__ float4 s_i8[kChunkBuckets];
    if (threadIdx.x < kChunkBuckets) {
      s_i8[threadIdx.x] = int8_bucket(meta + c * 2 * kChunkBuckets + 2 * threadIdx.x, row_meta, rows, own);
    }
    i8 = s_i8 + G * g;
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc_i[j][v] = 0u;
    }
  }
#pragma unroll 1
  for (int r0 = 0; r0 < rows; r0 += STAGE) {
    if (r0 > 0) __syncthreads();  // the previous stage is folded
    // Warp w copies plane rows w, w + 4, ... of the stage: lane q the q-th
    // VEC positions of the block's run.
#pragma unroll
    for (int e = warp; e < STAGE * BITS; e += kReduceWarps) {
      const int r = r0 + e / BITS;
      if (r < rows && r != own) {
        cp_async_vec<VEC>(&s_words[e][lane * VEC],
                          words + r * row_words + (c * BITS + e % BITS) * B + l0 + lane * VEC);
      }
    }
    for (int e = threadIdx.x; e < STAGE * 2 * kChunkBuckets / VEC; e += kReduceThreads) {
      const int rr = e * VEC / (2 * kChunkBuckets), i = e * VEC % (2 * kChunkBuckets);
      if (r0 + rr < rows && r0 + rr != own) {
        cp_async_vec<VEC>(&s_meta[rr][i], meta + (r0 + rr) * row_meta + c * 2 * kChunkBuckets + i);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < STAGE; ++rr) {
      const int r = r0 + rr;
      if (r >= rows) break;
      if (RAW && r == own) {
        if constexpr (!INT8) {  // the int8 fold adds the raw row last
#pragma unroll
          for (int j = 0; j < G; ++j) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              acc[j][v] = r == 0 ? raw_v[j][v] : __fadd_rn(acc[j][v], raw_v[j][v]);
            }
          }
        }
        continue;
      }
      float unit[G], bmin[G];
      const float4* m4 = reinterpret_cast<const float4*>(&s_meta[rr][2 * G * g]);
#pragma unroll
      for (int h = 0; h < G / 2; ++h) {
        const float4 t = m4[h];
        unit[2 * h] = t.x; bmin[2 * h] = t.y; unit[2 * h + 1] = t.z; bmin[2 * h + 1] = t.w;
      }
      uint32_t w[8][VEC];  // planes past BITS are 0
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < BITS) {
          lds_vec<VEC>(&s_words[rr * BITS + (k < BITS ? k : 0)][pv * VEC], w[k]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) w[k][v] = 0u;
        }
      }
      if constexpr (INT8) {
        uint32_t sr[G];
#pragma unroll
        for (int j = 0; j < G; ++j) sr[j] = int8_scale(unit[j], i8[j].x);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const uint32_t lo = level_nibbles(w[0][v], w[1][v], w[2][v], w[3][v], sel);
          const uint32_t hi = BITS > 4 ? level_nibbles(w[4][v], w[5][v], w[6][v], w[7][v], sel) : 0u;
#pragma unroll
          for (int j = 0; j < G; ++j) acc_i[j][v] += nibble_level_int<BITS>(lo, hi, j) * sr[j];
        }
        continue;
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const uint32_t lo = level_nibbles(w[0][v], w[1][v], w[2][v], w[3][v], sel);
        const uint32_t hi = BITS > 4 ? level_nibbles(w[4][v], w[5][v], w[6][v], w[7][v], sel) : 0u;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float val = __fadd_rn(bmin[j], __fmul_rn(unit[j], nibble_level<BITS>(lo, hi, j)));
          acc[j][v] = r == 0 ? val : __fadd_rn(acc[j][v], val);
        }
      }
    }
  }
  if constexpr (INT8) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float4 p = i8[j];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        acc[j][v] = int8_value(p, acc_i[j][v]);
        if constexpr (RAW) acc[j][v] = __fadd_rn(acc[j][v], raw_v[j][v]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) st_vec<VEC>(out + base + (size_t)j * B, acc[j]);
}

// ---------------------------------------------------------------------------
// The matmul-quantize (B8): a register-tiled f32 GEMM whose tiles complete
// the quantize chunks through the L2.
// ---------------------------------------------------------------------------

constexpr int kMmThreads = 128;  // 16 column groups x 8 row groups, 8 x 8 sums each
constexpr int kMmBM = 64;        // rows of dw (columns of x2) a tile covers
constexpr int kMmBN = 128;       // columns of dw (of g2) a tile covers
constexpr int kMmBK = 16;        // contraction steps one ring stage holds
constexpr int kMmStages = 4;     // stages of the shared-memory ring
constexpr int kMmStageElems = kMmBK * (kMmBM + kMmBN);  // operand values a stage holds

// A load that acquires at device scope: the writes released before the
// store or atomic it reads are visible after it.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Fill one ring stage: contraction rows k0 .. k0+15 of x2's columns
// i0 .. i0+63 (xs, 16 x 64) and of g2's columns j0 .. j0+127 (gs, 16 x 128),
// each a coalesced row segment, in the operands' element type E. Rows past
// K and columns past din or o are zero-filled and never summed. x_vec:
// x2's rows are whole 16-byte copies (din a multiple of 16/sizeof(E), x2
// 16-byte aligned), so x moves in 16-byte copies like g2; else in 4-byte
// copies (f32) or plain 2-byte loads and stores (16-bit), which the ring's
// barrier orders like the copies. g_vec: the same of g2, whose f32 rows
// are always whole copies (o % 4 == 0, g2 aligned: the entry's checks).
template <typename E>
__device__ __forceinline__ void mm_fill(E* st, const E* x2, const E* g2, long long k_total, int din,
                                        int o, long long k0, int i0, int j0, bool x_vec,
                                        bool g_vec) {
  constexpr int V = 16 / (int)sizeof(E);  // values a 16-byte copy moves
  E* xs = st;
  E* gs = st + kMmBK * kMmBM;
  if (x_vec) {
    for (int e = threadIdx.x; e < kMmBK * (kMmBM / V); e += kMmThreads) {
      const int u = e / (kMmBM / V), q = V * (e % (kMmBM / V));
      const bool in = k0 + u < k_total && i0 + q < din;
      cp_async16(xs + u * kMmBM + q, in ? x2 + (k0 + u) * din + i0 + q : x2, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kMmBK * kMmBM; e += kMmThreads) {
      const int u = e / kMmBM, q = e % kMmBM;
      const bool in = k0 + u < k_total && i0 + q < din;
      if constexpr (sizeof(E) == 4) {
        cp_async4(xs + u * kMmBM + q, in ? x2 + (k0 + u) * din + i0 + q : x2, in ? 4 : 0);
      } else {
        xs[u * kMmBM + q] = in ? x2[(k0 + u) * din + i0 + q] : E(0);
      }
    }
  }
  if (sizeof(E) == 4 || g_vec) {
    for (int e = threadIdx.x; e < kMmBK * (kMmBN / V); e += kMmThreads) {
      const int u = e / (kMmBN / V), q = V * (e % (kMmBN / V));
      const bool in = k0 + u < k_total && j0 + q < o;
      cp_async16(gs + u * kMmBN + q, in ? g2 + (k0 + u) * o + j0 + q : g2, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kMmBK * kMmBN; e += kMmThreads) {
      const int u = e / kMmBN, q = e % kMmBN;
      const bool in = k0 + u < k_total && j0 + q < o;
      gs[u * kMmBN + q] = in ? g2[(k0 + u) * o + j0 + q] : E(0);
    }
  }
}

// One contraction step of a thread's 8 x 8 sums. Thread (tx, ty) owns
// tile rows 4ty + {0..3} and 32 + 4ty + {0..3} (sums row r < 4: 4ty + r,
// else 28 + 4ty + r) and tile columns 4tx + {0..3} and 64 + 4tx + {0..3}:
// four 16-byte shared loads feed 64 __fmaf_rn, x times g plus the sum,
// the plain version's order with k ascending.
__device__ __forceinline__ void mm_step(float (&acc)[8][8], const float* xs, const float* gs,
                                        int tx, int ty) {
  const float4 a0 = *reinterpret_cast<const float4*>(xs + 4 * ty);
  const float4 a1 = *reinterpret_cast<const float4*>(xs + 32 + 4 * ty);
  const float4 b0 = *reinterpret_cast<const float4*>(gs + 4 * tx);
  const float4 b1 = *reinterpret_cast<const float4*>(gs + 64 + 4 * tx);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
  }
}

// The two 16-bit values of a 32-bit shared word as their exact floats, the
// lower address first: bf16 by a shift (its bits are a float's upper
// half), f16 (F16) by __half2float.
template <bool F16>
__device__ __forceinline__ void wire_pair(uint32_t w, float& lo, float& hi) {
  if constexpr (F16) {
    lo = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    hi = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  } else {
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xffff0000u);
  }
}

// mm_step on 16-bit operands: four 8-byte shared loads, each value
// converted exactly to f32 where it is read, then the same 64 __fmaf_rn in
// the same order. A product of two bf16 (or two f16) values is exact in
// f32, so the sums are those of the f32 instance on the upcast operands.
template <bool F16>
__device__ __forceinline__ void mm_step16(float (&acc)[8][8], const uint16_t* xs,
                                          const uint16_t* gs, int tx, int ty) {
  const uint2 a0 = *reinterpret_cast<const uint2*>(xs + 4 * ty);
  const uint2 a1 = *reinterpret_cast<const uint2*>(xs + 32 + 4 * ty);
  const uint2 b0 = *reinterpret_cast<const uint2*>(gs + 4 * tx);
  const uint2 b1 = *reinterpret_cast<const uint2*>(gs + 64 + 4 * tx);
  float a[8], b[8];
  wire_pair<F16>(a0.x, a[0], a[1]);
  wire_pair<F16>(a0.y, a[2], a[3]);
  wire_pair<F16>(a1.x, a[4], a[5]);
  wire_pair<F16>(a1.y, a[6], a[7]);
  wire_pair<F16>(b0.x, b[0], b[1]);
  wire_pair<F16>(b0.y, b[2], b[3]);
  wire_pair<F16>(b1.x, b[4], b[5]);
  wire_pair<F16>(b1.y, b[6], b[7]);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
  }
}

// The sums of one ring stage of 16-bit operands: `left` contraction steps
// (at most 16) in the format F16 says.
template <bool F16>
__device__ __forceinline__ void mm_stage16(float (&acc)[8][8], const uint16_t* xs,
                                           const uint16_t* gs, int tx, int ty, long long left) {
  if (left >= kMmBK) {
#pragma unroll
    for (int u = 0; u < kMmBK; ++u) mm_step16<F16>(acc, xs + u * kMmBM, gs + u * kMmBN, tx, ty);
  } else {
    for (int u = 0; u < (int)left; ++u) mm_step16<F16>(acc, xs + u * kMmBM, gs + u * kMmBN, tx, ty);
  }
}

// codec_matmul_quantize. Replaces fused_producer.py _matmul_quantize_impl
// (B8): dw = x2^T g2 (x2 (K, din), g2 (K, o), row-major, both of element
// type E), divided by div and quantized into the wire layout of the flat
// dw (din*o values, row major), plus the f32 values of dw / div at flat
// [raw_lo, raw_lo + raw_n) (the own raw row of the SRA; raw_n 0: none).
//
// Bound: operations, 2*K*din*o (a multiply and an add per product, f32
// FFMA) against sizeof(E)*K*(din + o) bytes read once and n*bits/8 + 8n/B
// written. The design: no tensor cores (one TF32 pass would round the f32
// operands to 11 significant bits), so it is an FFMA GEMM like cuBLAS's
// f32 kernels. The wrapper routes every float32 pair to the split-TF32
// kernel on the tensor cores (cgx_matmul_quantize_tf32_kernel below, whose
// three products a step keep f32 accuracy), and the 16-bit operands of a
// shape TMA can describe to cgx_matmul_quantize_tc_kernel; only the other
// 16-bit shapes (din or o not a multiple of 8, an operand not 16-byte
// aligned) come here, where their sums are the f32 instance's on the
// upcast operands, bit for bit, and any operands forced here
// (codec_cuda's _route="ffma"): the f32 instance keeps its bytes, the old
// anchor. The design:
//  - the GEMM tiling is the output's, not the quantize chunk's: 64 x 128
//    tiles of dw, every value computed exactly once (288 tiles at GPT-2
//    124M's mlp_in), walked by a persistent grid of as many blocks as the
//    SMs hold at once;
//  - both operands are K-major, so each contraction step is an outer
//    product of a coalesced row segment of x2 and of g2; a 4-stage ring of
//    16-step stages in shared memory, filled by cp.async, keeps three
//    stages in flight while the block sums the fourth;
//  - a thread keeps 8 x 8 sums in registers over the whole contraction,
//    one __fmaf_rn chain from 0 with k ascending, then __fdiv_rn(acc, div):
//    the order of the one-block-per-chunk kernel this design replaced, so
//    the bytes equal its bytes; no split-K.
// The 16-bit operands of a bf16 or f16 layer (E = uint16_t, the format the
// launch's `wire` argument, uniform across the grid; the JAX kernel reads
// its operands in the layer's compute dtype and contracts them with
// preferred_element_type=float32): the ring holds 2-byte values, so a
// stage is half as large, and each value becomes its exact f32 at the
// shared-memory read (mm_step16); the sums, the workspace and the quantize
// are the f32 instance's on the upcast operands, bit for bit. The own raw
// row is the layer's product in its compute dtype, as the JAX package
// takes it (dw_own.astype(w.dtype), then / div): each sum rounded to the
// wire dtype (round to nearest even) before the divide. The workspace
// keeps __fdiv_rn of the f32 sum, which the JAX kernel quantizes. The f32
// instances take `g_vec` and `wire` and never read them.
// The quantize needs each 32-bucket chunk whole, and a chunk spans the
// tiles of several blocks. Chunk completion through the L2 (chosen over a
// cluster holding whole chunks in distributed shared memory, whose group
// of 3-9 chunks would tie the GEMM tiling to the chunk geometry again):
// each tile writes its dw / div values into a workspace (4*din*o bytes,
// L2-resident at these shapes), fences, and adds its value count to each
// chunk's arrival counter. Chunk c belongs to block c % gridDim.x: once
// the block's tiles are done it waits for the chunk's 32*B arrivals, copies
// the chunk from the L2 into shared memory (the ring's space) and runs
// chunk_meta and chunk_encode on it (one block a chunk's body). The
// counters are the launch's own, zeroed on its stream before it.
// The launch is cooperative, so every block is resident and the waits
// cannot block a tile that is not running. Each chunk has its own block
// rather than the block whose arrival completes it: all tiles of a band of
// rows finish together, so that block would quantize every chunk of its
// band in turn (12 at mlp_in).
template <int BITS, int ENCODE, int PACK, typename E>
__global__ void __launch_bounds__(kMmThreads, 3)
    cgx_matmul_quantize_kernel(const E* __restrict__ x2, const E* __restrict__ g2,
                               long long k_total, int din, int o, int tiles_n, long long tiles,
                               float div, int B, float inv, int x_vec,
                               float* __restrict__ work, int* __restrict__ arrivals,
                               float* __restrict__ raw, long long raw_lo, long long raw_n,
                               int32_t* __restrict__ words, float* __restrict__ meta, int g_vec,
                               int wire) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_unit[kChunkBuckets];
  __shared__ float s_min[kChunkBuckets];
  E* ring = reinterpret_cast<E*>(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long chunk_n = (long long)kChunkBuckets * B;
  const long long nk = (k_total + kMmBK - 1) / kMmBK;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = (int)(t / tiles_n) * kMmBM;
    const int j0 = (int)(t % tiles_n) * kMmBN;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    }
#pragma unroll
    for (int st = 0; st < kMmStages - 1; ++st) {
      if (st < nk) {
        mm_fill<E>(ring + st * kMmStageElems, x2, g2, k_total, din, o, (long long)st * kMmBK, i0,
                   j0, x_vec, g_vec);
      }
      cp_async_commit();
    }
    for (long long kt = 0; kt < nk; ++kt) {
      cp_async_wait<kMmStages - 2>();  // this thread's copies of stage kt landed
      __syncthreads();                  // and everyone's; stage kt - 1 is summed
      const long long next = kt + kMmStages - 1;
      if (next < nk) {
        mm_fill<E>(ring + (next % kMmStages) * kMmStageElems, x2, g2, k_total, din, o,
                   next * kMmBK, i0, j0, x_vec, g_vec);
      }
      cp_async_commit();  // possibly empty: keeps the group count uniform
      const E* xs = ring + (kt % kMmStages) * kMmStageElems;
      const E* gs = xs + kMmBK * kMmBM;
      const long long left = k_total - kt * kMmBK;
      if constexpr (sizeof(E) == 2) {
        if (wire == kWireF16) {
          mm_stage16<true>(acc, xs, gs, tx, ty, left);
        } else {
          mm_stage16<false>(acc, xs, gs, tx, ty, left);
        }
      } else if (left >= kMmBK) {
#pragma unroll
        for (int u = 0; u < kMmBK; ++u) mm_step(acc, xs + u * kMmBM, gs + u * kMmBN, tx, ty);
      } else {  // the last stage of a K that is not a multiple of 16: exactly K sums
        for (int u = 0; u < (int)left; ++u) mm_step(acc, xs + u * kMmBM, gs + u * kMmBN, tx, ty);
      }
    }
    cp_async_wait<0>();

    // The tile's values of dw / div into the workspace (and the raw row).
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + (r < 4 ? 4 * ty + r : 28 + 4 * ty + r);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + 64 * h + 4 * tx;
        if (i < din && j < o) {
          float4 v;
          v.x = __fdiv_rn(acc[r][4 * h], div);
          v.y = __fdiv_rn(acc[r][4 * h + 1], div);
          v.z = __fdiv_rn(acc[r][4 * h + 2], div);
          v.w = __fdiv_rn(acc[r][4 * h + 3], div);
          const long long flat = (long long)i * o + j;
          __stcg(reinterpret_cast<float4*>(work + flat), v);
          if (flat >= raw_lo && flat < raw_lo + raw_n) {
            if constexpr (sizeof(E) == 2) {  // the product in the compute dtype, then / div
              v.x = __fdiv_rn(wire_round<E>(acc[r][4 * h], wire), div);
              v.y = __fdiv_rn(wire_round<E>(acc[r][4 * h + 1], wire), div);
              v.z = __fdiv_rn(wire_round<E>(acc[r][4 * h + 2], wire), div);
              v.w = __fdiv_rn(wire_round<E>(acc[r][4 * h + 3], wire), div);
            }
            *reinterpret_cast<float4*>(raw + (flat - raw_lo)) = v;
          }
        }
      }
    }
    __threadfence();  // the values are visible device-wide before any arrival counts them
    __syncthreads();  // every thread's values (and the ring is free for the next tile)
    // One arrival per row of the tile: its segment [i*o + j0, i*o + j1)
    // adds its length to the chunk (or the two chunks) it lies in.
    const int j1 = min(j0 + kMmBN, o);
    for (int r = threadIdx.x; r < kMmBM; r += kMmThreads) {
      const int i = i0 + r;
      if (i >= din) continue;
      long long lo = (long long)i * o + j0;
      const long long hi = (long long)i * o + j1;
      while (lo < hi) {
        const long long c = lo / chunk_n;
        const long long end = min(hi, (c + 1) * chunk_n);
        atomicAdd(arrivals + c, (int)(end - lo));
        lo = end;
      }
    }
  }

  // This block's chunks: wait for all 32*B values, stage, quantize.
  const long long chunks = (long long)din * o / chunk_n;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    if (threadIdx.x == 0) {
      while (ld_acquire(arrivals + c) < chunk_n) __nanosleep(128);
    }
    __syncthreads();
    const float* src = work + c * chunk_n;
    for (long long e = threadIdx.x; e < chunk_n / 4; e += kMmThreads) {
      cp_async16(smem + 4 * e, src + 4 * e, 16);  // from the L2, where the values are
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    chunk_meta<ENCODE>(smem, B, inv, s_unit, s_min, meta + c * 2 * kChunkBuckets);
    __syncthreads();
    chunk_encode<BITS, ENCODE, PACK>(smem, B, s_unit, s_min, words + c * BITS * B);
    __syncthreads();  // the tile and the meta are free for the next chunk
  }
}

// ---------------------------------------------------------------------------
// Pipelined (DB) kernels. They replace the double-buffered manual-DMA
// lowerings of codec_pallas.py, which walk the blocks in one kernel
// invocation with a 2-slot VMEM scratch per stream:
//   cgx_quantize_db         <- _quantize_flat_db_impl (B7a)
//   cgx_dequantize_db       <- _dequantize_flat_db_impl (B7b)
//   cgx_sra_epilogue_db     <- _sra_epilogue_db_impl (B7c)
// Each computes what its single-stage sibling computes, with the same
// per-value arithmetic, so the bytes are identical. All three stay
// memory-bound, with the bounds of their siblings. Their inputs stream
// through a ring of slots in dynamic shared memory filled by 1-D bulk
// asynchronous copies (cp.async.bulk ... mbarrier::complete_tx::bytes),
// each slot with an mbarrier whose phase completes when the announced
// bytes (mbarrier.arrive.expect_tx) have landed. Bulk copies need 16-byte
// aligned addresses and sizes in multiples of 16: every per-chunk stride
// (32*B*4, bits*B*4, 256 bytes of meta, and a CTA's share of them, B/k
// positions in whole warps) is one for B % 32 == 0, and the wrappers
// check the base pointers.
//
// B7b, here: a persistent grid of (blocks an SM holds at the kernel's
// shared memory) x (SMs) blocks; block b walks tiles b, b + gridDim.x, ...
// A tile is `tc` consecutive chunks, a slot one tile; thread 0 issues the
// copies, every thread waits on the slot's phase, and the slot is refilled
// only after a __syncthreads() says every thread is done with it. So the
// copy of the next tiles runs while the block computes this one; outputs
// go from registers straight to device memory (coalesced: neighbouring
// threads own neighbouring positions l).
//
// B7a and B7c run on the cluster body of B1 and B3, fed by a ring of each
// CTA's share of a chunk: see "The pipelined cluster kernels" below.
// ---------------------------------------------------------------------------

constexpr int kDbThreads = 512;
constexpr int kRing = 2;      // slots of the dequantize ring
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

// A barrier that completes a phase once `count` arrivals have come.
__device__ __forceinline__ void mbar_init_count(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// `count` arrivals at once (release: this thread's reads and writes before
// it are ordered before the phase's completion).
__device__ __forceinline__ void mbar_arrive_count(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
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

// ---------------------------------------------------------------------------
// The cluster kernels: B1/B5 (cgx_quantize_cluster_kernel) and B3
// (cgx_sra_epilogue_cluster_kernel).
//
// What bounds them. By their bytes both are memory-bound (the bounds above),
// but a GPT-2 124M step launches them mostly on 108-144 chunks (a layer's
// payload: 7-10 MB read by B1, 2-3 MB by one-row B3), where the chunk's
// dependency chain (loads, a reduce across warps and CTAs, the encode, the
// stores) and the instructions each value needs bound a launch, not the
// bytes; at a 64 MB slice B1 reaches about half its byte bound (PERF.md,
// PR 7). The one-block-per-chunk design before this one left most SMs
// with one 8-warp block or none at those counts, walked each bucket in a
// dependent loop and read the chunk twice; its B3 staged a (32, B) f32
// tile in 64 KB of shared memory and read or wrote each value there about
// five times.
//
// The design:
//  - a thread-block cluster of k CTAs (k in {1, 2, 4, 8}) takes one chunk;
//    CTA `rank` owns the contiguous positions [rank*B/k, (rank+1)*B/k), its
//    thread t position l = rank*B/k + t, for all 32 buckets.
//    codec_cuda.cluster_geometry picks k from the chunk count, the card's
//    SMs and B (see its rule: one CTA an SM up to one SM's worth of chunks,
//    several up to 1.6 SMs' worth, k = 1 above); k = 1 is a plain launch;
//  - a thread holds its 32 values in registers: B1 loads each value once,
//    coalesced across the warp, 32 independent loads a thread; B3 decodes
//    the ws rows (the raw own row in place of row `own`) and folds them into
//    those registers in ascending row order. No shared-memory tile, no
//    second read;
//  - max and min per bucket: across the warp by a transpose-reduce (five
//    shuffle stages halve the buckets a lane holds, leaving lane s with
//    bucket s), across the CTA's warps in shared memory, then across the
//    cluster through distributed shared memory (a cluster barrier, mapa +
//    ld.shared::cluster). CTA rank 0 stores the chunk's meta;
//  - each thread encodes and packs its position from registers: under the
//    sum pack it ORs bucket s's level bits into bit s of its BITS words;
//    under the butterfly pack its warp stages the levels of its 32
//    positions in a private, bank-rotated 32 x 32 stage and makes each word
//    one __ballot_sync (the ballot's axis is the bucket, the register
//    layout's is the position, so the transpose stays);
//  - the div encode multiplies by the bucket's correctly rounded reciprocal
//    and corrects the quotient with one explicit FMA step (div_quotient),
//    where the bucket's divisor and the value lie in the range on which
//    that quotient is the IEEE divide's (checked on the card by
//    cgx_div_sweep); other buckets, and values with 0 < a < 2^-62, take
//    __fdiv_rn (one unsigned compare a value against a per-bucket bound).
// The register budget is one position (32 values) a thread, so a chunk
// fits 8 CTAs of 512 threads up to B = 4096. Past it (and at a B whose
// warps of positions no k divides into at most 512 threads) the same
// kernels run with REREAD: a thread takes several positions of its CTA's
// range in rounds, each loaded (B3: folded) once for the extremes and
// again, from the L2, for the encode.
// ---------------------------------------------------------------------------

constexpr int kClusterMaxThreads = 512;
constexpr int kClusterMaxWarps = kClusterMaxThreads / 32;
// Two 512-thread CTAs an SM (at most 64 registers a thread): the 32 values
// and the reduce's 16 fit, and smaller CTAs get four or eight an SM. With
// REREAD one (at most 128 registers): the rounds' loop state spills at 64.
constexpr int kClusterMinBlocks = 2;
constexpr int kClusterMaxSize = 8;

// The reciprocal quotient is the IEEE one where 2^-64 <= safe < 2^64 and
// the numerator a = x - min is 0 or at least 2^-62 (div_quotient). (safe is
// positive or +inf by construction.)
constexpr int kRcpExpLo = 127 - 64;
constexpr int kRcpExpHi = 127 + 64;
// The least nonzero numerator the reciprocal divides, 2^-62, as float bits.
constexpr uint32_t kRcpMinNumeratorBits = (uint32_t)(127 - 62) << 23;

__device__ __forceinline__ bool rcp_in_range(float safe) {
  const int e = (__float_as_int(safe) >> 23) & 0xff;
  return e >= kRcpExpLo && e < kRcpExpHi;
}

// The bucket's reciprocal for the div encode: __frcp_rn(safe) in range, 0
// (take the IEEE divide) outside it.
__device__ __forceinline__ float div_reciprocal(float safe) {
  return rcp_in_range(safe) ? __frcp_rn(safe) : 0.f;
}

// The bucket's bound for div_quotient's one per-value test: a numerator
// whose bits less one are at most this takes the IEEE divide. In range,
// the nonzero numerators below 2^-62; outside it, every numerator.
__device__ __forceinline__ uint32_t div_slow_bits(float safe) {
  return rcp_in_range(safe) ? kRcpMinNumeratorBits - 2u : 0xffffffffu;
}

// a / safe, correctly rounded, bit for bit __fdiv_rn(a, safe): q = a*r,
// then one correction with the remainder a - safe*q (Markstein). The
// correction rounds correctly where r = RN(1/safe), q is within an ulp of
// a/safe, the remainder is exact and nothing leaves the normal range. With
// safe in [2^-64, 2^64), a >= 2^-62 and a in the level domain (a = x - min
// <= max - min, about 2^8 * safe at most) the reciprocal, a*r and the
// quotient are normal (a/safe > 2^-126), and a's exponent lies far enough
// above the subnormals (>= -102) that the remainder is a float. The
// remainder is formed negated, -(safe*q - a), so that a = +-0 gives a zero
// of a's sign, as the IEEE divide does. Numerators in (0, 2^-62) (per
// value; rare: a nonzero a below 2^-62 needs x or the min within 2^-38 of
// zero) and every value of a bucket outside the range take the IEEE
// divide: one unsigned compare, `slow` from div_slow_bits (a = 0 wraps
// past it; NaN, and -0, take the fast path, NaN either way). The card's
// cgx_div_sweep finds no quotient different over every divisor
// significand.
__device__ __forceinline__ float div_quotient(float a, float safe, float rcp, uint32_t slow) {
  if (__float_as_uint(a) - 1u > slow) {
    const float q = __fmul_rn(a, rcp);
    const float en = __fmaf_rn(safe, q, -a);
    return __fmaf_rn(-en, rcp, q);
  }
  return __fdiv_rn(a, safe);
}

// The level of x in a bucket from its parameters p: div: (safe, its
// div_reciprocal, min, its div_slow_bits as float bits); mul: (the
// reciprocal 1/safe, -, min, -). STOCH: rounded with the offset r in
// [0, 1) in place of 0.5.
template <int BITS, int ENCODE, bool STOCH = false>
__device__ __forceinline__ uint32_t level_cluster(float x, float4 p, float r = 0.5f) {
  const float maxlvl = (float)((1 << BITS) - 1);
  const float a = __fsub_rn(x, p.z);
  const float q = ENCODE == kEncodeMul ? __fmul_rn(a, p.x)
                                       : div_quotient(a, p.x, p.y, __float_as_uint(p.w));
  return (uint32_t)fminf(fmaxf(floorf(__fadd_rn(q, STOCH ? r : 0.5f)), 0.f), maxlvl);
}

// Philox4x32-10 of counter c under key (k0, k1) (Random123): ten rounds,
// the key bumped by the Weyl constants between them.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// A word's rounding offset: (u >> 8) * 2^-24, exact.
__device__ __forceinline__ float uniform24(uint32_t u) {
  return __fmul_rn(__uint2float_rn(u >> 8), 5.9604644775390625e-08f);
}

// One chunk's stochastic-rounding stream (the counter layout above): the
// seed's words and the chunk index's counter words, tag 0.
struct ChunkStream {
  uint32_t k0, k1, c_lo, c_hi;
  // The four words of bucket group g (buckets 4g .. 4g + 3) at position l.
  __device__ __forceinline__ uint4 draw(int l, int g) const {
    return philox4x32_10(make_uint4((uint32_t)l, c_lo, c_hi, (uint32_t)g), k0, k1);
  }
};

__device__ __forceinline__ ChunkStream chunk_stream(uint2 seed, size_t c) {
  return ChunkStream{seed.x, seed.y, (uint32_t)c, (uint32_t)(c >> 32) & 0xffffu};
}

__device__ __forceinline__ uint32_t word_of(uint4 u, int j) {
  return j == 0 ? u.x : j == 1 ? u.y : j == 2 ? u.z : u.w;
}

// One transpose-reduce stage: t[0..2H) -> t[0..H). A lane with bit H set
// keeps the upper half and sends the lower one to its partner, which
// keeps the lower half: afterwards t[i] of a lane covers bucket
// (lane's bits above H) + i.
template <bool MAX, int H>
__device__ __forceinline__ void bucket_reduce_stage(float (&t)[16], int lane) {
  const bool hi = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = hi ? t[i] : t[i + H];
    const float keep = hi ? t[i + H] : t[i];
    const float got = __shfl_xor_sync(0xffffffffu, send, H);
    t[i] = MAX ? nan_max(keep, got) : nan_min(keep, got);
  }
}

// The warp's max (or min) of bucket `lane` over the warp's positions: five
// shuffle stages transpose and reduce (31 shuffles for 32 buckets).
template <bool MAX>
__device__ __forceinline__ float warp_bucket_extreme(const float (&v)[kChunkBuckets], int lane) {
  const bool hi = (lane & 16) != 0;
  float t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float lo = v[i], up = v[i + 16];
    const float got = __shfl_xor_sync(0xffffffffu, hi ? lo : up, 16);
    t[i] = MAX ? nan_max(hi ? up : lo, got) : nan_min(hi ? up : lo, got);
  }
  bucket_reduce_stage<MAX, 8>(t, lane);
  bucket_reduce_stage<MAX, 4>(t, lane);
  bucket_reduce_stage<MAX, 2>(t, lane);
  bucket_reduce_stage<MAX, 1>(t, lane);
  return t[0];
}

// Cluster barrier halves: every thread of every CTA of the cluster arrives;
// the wait returns once all have. Release / acquire order the shared-memory
// writes before the arrival against the reads after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A float of CTA `rank`'s shared memory at the address of `p` in this CTA's.
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// What a cluster body stores besides its words: B1's (unit, min) pairs, or
// one of B9's diagnostic variants (tools/qbench.py make_variant_kernel; the
// entry point's `variant` argument, codec_cuda.VARIANTS by index):
//   kVariantNoMeta   B1's words, zero pairs where B1 stores (unit, min);
//   kVariantMetaLane B1's words, per chunk one 128-float meta row
//                    [32 units | 32 mins | 64 zeros] (a full-width store);
//   kVariantRead     no encode and no pack: each of the chunk's bits*B words
//                    holds the int32 (toward zero, saturating, NaN -> 0) of
//                    the largest unit of its 32 buckets, and the usual pairs.
constexpr int kVariantNone = -1;
constexpr int kVariantNoMeta = 0;
constexpr int kVariantMetaLane = 1;
constexpr int kVariantRead = 2;

// Each bucket's encode parameters from this warp's extremes (lane s: the
// max and min of bucket s over the warp's positions): across the CTA's
// warps in shared memory, then across the cluster through distributed
// shared memory. CTA rank 0 stores the chunk's meta (mout) as VARIANT says.
// s_par[s] gets bucket s's parameters for level_cluster; under kVariantRead
// *s_word gets the chunk's word (every CTA reduces the same 32 units, so
// each has it without a read of its peers'). With k > 1 this CTA has
// arrived at the cluster barrier's second phase on return; cluster_quantize
// waits.
template <int ENCODE, int VARIANT = kVariantNone>
__device__ __forceinline__ void cluster_bucket_params(float wmx, float wmn, int k, int rank,
                                                      float inv, float* mout, float4* s_par,
                                                      int32_t* s_word = nullptr) {
  __shared__ float s_red[2][kClusterMaxWarps][kChunkBuckets];  // each warp's max, min
  __shared__ float s_part[2][kChunkBuckets];                   // this CTA's, read by its peers
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  s_red[0][warp][lane] = wmx;
  s_red[1][warp][lane] = wmn;
  __syncthreads();
  float mx = 0.f, mn = 0.f;
  if (warp == 0) {
    mx = s_red[0][0][lane];
    mn = s_red[1][0][lane];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      mx = nan_max(mx, s_red[0][w][lane]);
      mn = nan_min(mn, s_red[1][w][lane]);
    }
    s_part[0][lane] = mx;
    s_part[1][lane] = mn;
  }
  if (k > 1) {
    cluster_arrive();  // this CTA's partials are written
    cluster_wait();    // and every peer's
    if (warp == 0) {
      mx = ld_cluster(&s_part[0][lane], 0);
      mn = ld_cluster(&s_part[1][lane], 0);
      for (int r = 1; r < k; ++r) {
        mx = nan_max(mx, ld_cluster(&s_part[0][lane], r));
        mn = nan_min(mn, ld_cluster(&s_part[1][lane], r));
      }
    }
  }
  if (warp == 0) {
    const float unit = __fmul_rn(__fsub_rn(mx, mn), inv);
    const float safe = unit > 0.f ? unit : 1.f;
    s_par[lane] = ENCODE == kEncodeMul ? make_float4(__fdiv_rn(1.f, safe), 0.f, mn, 0.f)
                                       : make_float4(safe, div_reciprocal(safe), mn,
                                                     __uint_as_float(div_slow_bits(safe)));
    if constexpr (VARIANT == kVariantNoMeta) {
      if (rank == 0) reinterpret_cast<float2*>(mout)[lane] = make_float2(0.f, 0.f);
    } else if constexpr (VARIANT == kVariantMetaLane) {
      if (rank == 0) {
        mout[lane] = unit;
        mout[kChunkBuckets + lane] = mn;
        mout[2 * kChunkBuckets + lane] = 0.f;
        mout[3 * kChunkBuckets + lane] = 0.f;
      }
    } else {
      if (rank == 0) reinterpret_cast<float2*>(mout)[lane] = make_float2(unit, mn);
    }
    if constexpr (VARIANT == kVariantRead) {
      // The unit, not safe: a constant bucket's unit is 0, its safe 1.
      const bool nan = __any_sync(0xffffffffu, isnan(unit));
      float top = unit;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, o));
      if (lane == 0) *s_word = nan ? 0 : __float2int_rz(top);
    }
  }
  if (k > 1) cluster_arrive();  // this CTA has read its peers' partials
  __syncthreads();
}

// Encode and pack position l of the chunk from v (v[s]: bucket s) into its
// BITS words at wout[b*B + l]. Sum pack: bucket s's level bits go to bit s
// of the thread's words. Butterfly pack: the warp stages the levels of its
// 32 positions in its private, bank-rotated 32 x 32 words of `stage` and
// makes each word one __ballot_sync (the ballot's axis is the bucket, the
// register layout's the position, so the transpose stays). STOCH: each
// group of four buckets rounds with the offsets of one draw of `rs`, made
// where the group is encoded.
template <int BITS, int ENCODE, int PACK, bool STOCH>
__device__ __forceinline__ void cluster_encode(const float (&v)[kChunkBuckets],
                                               const float4* s_par, int B, int l, int32_t* wout,
                                               uint32_t* stage, const ChunkStream& rs) {
  uint32_t w[BITS];
#pragma unroll
  for (int b = 0; b < BITS; ++b) w[b] = 0u;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (PACK == kPackSum) {
#pragma unroll
    for (int s = 0; s < kChunkBuckets; ++s) {
      if constexpr (STOCH) {
        if (s % 4 == 0) u = rs.draw(l, s / 4);
      }
      const uint32_t q =
          level_cluster<BITS, ENCODE, STOCH>(v[s], s_par[s], uniform24(word_of(u, s % 4)));
#pragma unroll
      for (int b = 0; b < BITS; ++b) w[b] |= ((q >> b) & 1u) << s;
    }
  } else {
    const int lane = threadIdx.x & 31;
    uint32_t* st = stage + (size_t)(threadIdx.x >> 5) * 32 * 32;
#pragma unroll
    for (int s = 0; s < kChunkBuckets; ++s) {
      if constexpr (STOCH) {
        if (s % 4 == 0) u = rs.draw(l, s / 4);
      }
      st[s * 32 + ((lane + s) & 31)] =
          level_cluster<BITS, ENCODE, STOCH>(v[s], s_par[s], uniform24(word_of(u, s % 4)));
    }
    __syncwarp();
#pragma unroll 4
    for (int p = 0; p < 32; ++p) {
      const uint32_t q = st[lane * 32 + ((p + lane) & 31)];  // bucket lane, the warp's position p
#pragma unroll
      for (int b = 0; b < BITS; ++b) {
        const uint32_t bit = __ballot_sync(0xffffffffu, (q >> b) & 1u);
        w[b] = lane == p ? bit : w[b];
      }
    }
    __syncwarp();  // the stage's reads are done before a next position writes it
  }
#pragma unroll
  for (int b = 0; b < BITS; ++b) wout[(size_t)b * B + l] = (int32_t)w[b];
}

// Meta, encode and pack of one chunk by its cluster. CTA `rank` owns the
// positions [rank*B/k, (rank+1)*B/k), its thread t position l0 = rank*B/k +
// t and, with REREAD, l0 + T, l0 + 2T, ... below the CTA's end (T threads;
// B/k and T are whole warps, so a warp's positions of a round are all in
// range or all out, and round 0 has every warp). On entry v holds position
// l0's values (v[s]: bucket s). Without REREAD that is the thread's only
// position and its values stay in registers from the reduce to the encode.
// With REREAD, load(v, l) fills v with position l's values: each further
// position is loaded for the extremes, and every position again (from the
// L2) for the encode. wout, mout: the chunk's words and meta; stage
// (butterfly pack only): 32 x 32 words a warp of dynamic shared memory;
// rs: the chunk's stochastic-rounding stream (read with STOCH only).
// VARIANT (B9; cluster_bucket_params): the meta store it names, and under
// kVariantRead, in place of the encode, each thread stores the chunk's word
// (from s_word, a shared int) in its BITS words at each of its positions,
// with nothing read again.
template <int BITS, int ENCODE, int PACK, bool REREAD, bool STOCH, typename Load,
          int VARIANT = kVariantNone>
__device__ __forceinline__ void cluster_quantize(float (&v)[kChunkBuckets], const Load& load, int k,
                                                 int rank, int B, float inv, int32_t* wout,
                                                 float* mout, uint32_t* stage,
                                                 const ChunkStream& rs,
                                                 int32_t* s_word = nullptr) {
  __shared__ float4 s_par[kChunkBuckets];
  const int lane = threadIdx.x & 31;
  const int T = blockDim.x;
  const int l0 = rank * (B / k) + (int)threadIdx.x;
  const int room = B / k - (int)(threadIdx.x & ~31u);  // this warp's positions: l0 + off, off < room
  float wmx = warp_bucket_extreme<true>(v, lane);
  float wmn = warp_bucket_extreme<false>(v, lane);
  if constexpr (REREAD) {
    for (int off = T; off < room; off += T) {
      load(v, l0 + off);
      wmx = nan_max(wmx, warp_bucket_extreme<true>(v, lane));
      wmn = nan_min(wmn, warp_bucket_extreme<false>(v, lane));
    }
  }
  cluster_bucket_params<ENCODE, VARIANT>(wmx, wmn, k, rank, inv, mout, s_par, s_word);
  if constexpr (VARIANT == kVariantRead) {
    const int32_t word = *s_word;
    for (int off = 0; off < room; off += T) {
#pragma unroll
      for (int b = 0; b < BITS; ++b) wout[(size_t)b * B + l0 + off] = word;
    }
  } else if constexpr (REREAD) {
    for (int off = 0; off < room; off += T) {
      if (room > T) load(v, l0 + off);  // else v still holds position l0
      cluster_encode<BITS, ENCODE, PACK, STOCH>(v, s_par, B, l0 + off, wout, stage, rs);
    }
  } else {
    cluster_encode<BITS, ENCODE, PACK, STOCH>(v, s_par, B, l0, wout, stage, rs);
  }
  if (k > 1) cluster_wait();  // no CTA leaves while a peer may still read its partials
}

// B1's values of one chunk: v[s] = src[s*B + l], one load a bucket,
// coalesced across the warp, upcast from the wire dtype in registers.
template <typename E>
struct ChunkValues {
  const E* src;
  int B, wire;
  __device__ __forceinline__ void operator()(float (&v)[kChunkBuckets], int l) const {
#pragma unroll
    for (int s = 0; s < kChunkBuckets; ++s) v[s] = wire_ldg(src + (size_t)s * B + l, wire);
  }
};

// codec_quantize (B1, B5) on the cluster geometry: grid chunks*k CTAs in
// clusters of k, T threads (B/k, or with REREAD fewer: B/k positions in
// rounds of T); dynamic shared memory the butterfly stage (T/32 * 4096
// bytes) or none. STOCH: rounded with the stream of `seed`. x: E values of
// the wire dtype `wire`.
template <int BITS, int ENCODE, int PACK, bool REREAD, bool STOCH, typename E>
__global__ void __launch_bounds__(kClusterMaxThreads, REREAD ? 1 : kClusterMinBlocks)
    cgx_quantize_cluster_kernel(const E* __restrict__ x, int32_t* __restrict__ words,
                                float* __restrict__ meta, int B, int k, float inv, uint2 seed,
                                int wire) {
  extern __shared__ __align__(16) uint32_t cl_smem[];
  const int rank = (int)(blockIdx.x % (unsigned)k);
  const size_t c = blockIdx.x / (unsigned)k;
  const ChunkValues<E> load{x + c * kChunkBuckets * B, B, wire};
  float v[kChunkBuckets];
  load(v, rank * (B / k) + (int)threadIdx.x);
  cluster_quantize<BITS, ENCODE, PACK, REREAD, STOCH>(v, load, k, rank, B, inv,
                                                      words + c * BITS * B,
                                                      meta + c * 2 * kChunkBuckets, cl_smem,
                                                      chunk_stream(seed, c));
}

// codec_quantize_variant (B9) on B1's cluster body and geometry:
// cgx_quantize_cluster_kernel at the JAX variants' fixed lowering (the div
// encode, the sum pack, round to nearest, f32 input) with the store VARIANT
// names (cluster_bucket_params). The loads, the warp's transpose-reduce
// and the cluster reduce are B1's, so the variants less B1 split B1's time
// into its meta store, its encode and pack, and the rest. meta: the chunks'
// pairs (chunks*32*2 f32), or under kVariantMetaLane their 128-float rows.
template <int BITS, int VARIANT, bool REREAD>
__global__ void __launch_bounds__(kClusterMaxThreads, REREAD ? 1 : kClusterMinBlocks)
    cgx_quantize_variant_cluster_kernel(const float* __restrict__ x, int32_t* __restrict__ words,
                                        float* __restrict__ meta, int B, int k, float inv) {
  __shared__ int32_t s_word;  // kVariantRead: the chunk's word
  const int rank = (int)(blockIdx.x % (unsigned)k);
  const size_t c = blockIdx.x / (unsigned)k;
  const ChunkValues<float> load{x + c * kChunkBuckets * B, B, kWireF32};
  float v[kChunkBuckets];
  load(v, rank * (B / k) + (int)threadIdx.x);
  cluster_quantize<BITS, kEncodeDiv, kPackSum, REREAD, false, ChunkValues<float>, VARIANT>(
      v, load, k, rank, B, inv, words + c * BITS * B,
      meta + c * (VARIANT == kVariantMetaLane ? 128 : 2 * kChunkBuckets), nullptr,
      chunk_stream(make_uint2(0u, 0u), c), &s_word);
}

// The BITS words of one row at this thread's position.
template <int BITS>
__device__ __forceinline__ void load_words(uint32_t (&w)[BITS], const int32_t* __restrict__ wrow,
                                           int B, int l) {
#pragma unroll
  for (int b = 0; b < BITS; ++b) w[b] = (uint32_t)__ldg(wrow + (size_t)b * B + l);
}

// Fold one row into acc: its decoded values (meta from shared memory), or
// with `rawc` the raw own row's (E values of the wire dtype `wire`, upcast
// in registers). FIRST: acc takes the row's values as they are (the plain
// fold's v0 + v1 + ... starts from v0, not 0 + v0).
template <int BITS, bool FIRST, typename E>
__device__ __forceinline__ void fold_row(float (&acc)[kChunkBuckets], const uint32_t (&w)[BITS],
                                         const float* s_meta, const E* __restrict__ rawc,
                                         int B, int l, int wire) {
  if (rawc != nullptr) {
#pragma unroll
    for (int s = 0; s < kChunkBuckets; ++s) {
      const float v = wire_ldg(rawc + (size_t)s * B + l, wire);
      acc[s] = FIRST ? v : __fadd_rn(acc[s], v);
    }
    return;
  }
#pragma unroll
  for (int s = 0; s < kChunkBuckets; ++s) {
    const float2 m = reinterpret_cast<const float2*>(s_meta)[s];
    const float v = decode_one<BITS>(w, s, m.x, m.y);
    acc[s] = FIRST ? v : __fadd_rn(acc[s], v);
  }
}

// Fold one kept row into the int8 fold's sums: each bucket's level, as an
// integer, times the row's scale (one integer multiply-add a value).
template <int BITS>
__device__ __forceinline__ void fold_row_int8(uint32_t (&acc_i)[kChunkBuckets],
                                              const uint32_t (&w)[BITS], const uint32_t* scale) {
#pragma unroll
  for (int s = 0; s < kChunkBuckets; ++s) {
    uint32_t q = 0u;
#pragma unroll
    for (int k = 0; k < BITS; ++k) q |= ((w[k] >> s) & 1u) << k;
    acc_i[s] += q * scale[s];
  }
}

// The int8 fold's values of a position from its sums (par: the buckets'
// int8_bucket), the raw own row (rawc, or null) added last.
template <typename E>
__device__ __forceinline__ void int8_finish(float (&acc)[kChunkBuckets],
                                            const uint32_t (&acc_i)[kChunkBuckets],
                                            const float4* par, const E* __restrict__ rawc, int B,
                                            int l, int wire) {
#pragma unroll
  for (int s = 0; s < kChunkBuckets; ++s) {
    acc[s] = int8_value(par[s], acc_i[s]);
    if (rawc != nullptr) acc[s] = __fadd_rn(acc[s], wire_ldg(rawc + (size_t)s * B + l, wire));
  }
}

// The int8 fold's shared memory of a chunk of ws rows: the buckets'
// parameters (32 float4), then each row's scales (ws x 32 words).
__host__ __device__ constexpr size_t int8_smem_bytes(int ws) {
  return kChunkBuckets * 16 + (size_t)ws * kChunkBuckets * 4;
}

// The folded values of a position rounded through the wire dtype (B3, B7c:
// codec_pallas.py _requant_cast); nothing for E = float.
template <typename E>
__device__ __forceinline__ void requant_cast(float (&acc)[kChunkBuckets], int wire) {
  if constexpr (sizeof(E) == 2) {
#pragma unroll
    for (int s = 0; s < kChunkBuckets; ++s) acc[s] = wire_round<E>(acc[s], wire);
  }
}

// B3's values of one chunk: the ws rows at a position, folded in ascending
// row order, the raw own row (rawc, or null) in place of row `own`, then
// rounded through the wire dtype. wc: row 0's words of the chunk, rows
// row_words apart; s_meta: the rows' meta of the chunk, staged in shared
// memory.
template <int BITS, typename E, int ACCUM = kAccumExact>
struct ChunkRows {
  const int32_t* wc;
  size_t row_words;
  const float* s_meta;
  const E* rawc;
  int own, ws, B, wire;
  const float4* i8_par;  // the int8 fold's parameters and scales (int8_prologue)
  const uint32_t* i8_scale;

  // w holds row 0's words at l on entry (unless row 0 is the raw row).
  __device__ __forceinline__ void fold(float (&acc)[kChunkBuckets], uint32_t (&w)[BITS],
                                       int l) const {
    if constexpr (ACCUM == kAccumInt8) {
      uint32_t acc_i[kChunkBuckets];
#pragma unroll
      for (int s = 0; s < kChunkBuckets; ++s) acc_i[s] = 0u;
      for (int r = 0; r < ws; ++r) {
        if (r == own) continue;
        if (r > 0) load_words<BITS>(w, wc + r * row_words, B, l);
        fold_row_int8<BITS>(acc_i, w, i8_scale + r * kChunkBuckets);
      }
      int8_finish<E>(acc, acc_i, i8_par, rawc, B, l, wire);
    } else {
      fold_row<BITS, true, E>(acc, w, s_meta, own == 0 ? rawc : nullptr, B, l, wire);
      for (int r = 1; r < ws; ++r) {
        if (r != own) load_words<BITS>(w, wc + r * row_words, B, l);
        fold_row<BITS, false, E>(acc, w, s_meta + r * 2 * kChunkBuckets, r == own ? rawc : nullptr,
                                 B, l, wire);
      }
    }
    requant_cast<E>(acc, wire);
  }

  __device__ __forceinline__ void operator()(float (&acc)[kChunkBuckets], int l) const {
    uint32_t w[BITS] = {};
    if (own != 0) load_words<BITS>(w, wc, B, l);
    fold(acc, w, l);
  }
};

// codec_sra_epilogue (B3) on the cluster geometry: the ws rows' meta of the
// chunk are staged in dynamic shared memory (ws * 256 bytes, ahead of the
// butterfly stage) while row 0's words are in flight; each thread folds
// its position of the ws rows into 32 registers in ascending row order,
// then requantizes them as B1 does (with REREAD, each further position is
// folded again for the encode); STOCH: with the stream of `seed`, chunk
// indices over the output row. E, `wire`: the wire dtype, the raw row's
// and the one the folded values round through.
template <int BITS, int ENCODE, int PACK, bool REREAD, bool STOCH, typename E,
          int ACCUM = kAccumExact>
__global__ void __launch_bounds__(kClusterMaxThreads, REREAD ? 1 : kClusterMinBlocks)
    cgx_sra_epilogue_cluster_kernel(const int32_t* __restrict__ words,
                                    const float* __restrict__ meta,
                                    const E* __restrict__ raw, int own, int ws,
                                    long long chunks, int B, int k, float inv,
                                    int32_t* __restrict__ out_words,
                                    float* __restrict__ out_meta, uint2 seed, int wire) {
  extern __shared__ __align__(16) uint32_t cl_smem[];
  constexpr bool INT8 = ACCUM == kAccumInt8;
  float* s_meta = reinterpret_cast<float*>(cl_smem);  // [ws][32][2]
  // The int8 fold's parameters and scales (int8_smem_bytes) follow the
  // meta; then the butterfly stage.
  float4* i8_par = reinterpret_cast<float4*>(cl_smem + (size_t)ws * 2 * kChunkBuckets);
  uint32_t* i8_scale = reinterpret_cast<uint32_t*>(i8_par + kChunkBuckets);
  uint32_t* stage = cl_smem + (size_t)ws * 2 * kChunkBuckets + (INT8 ? int8_smem_bytes(ws) / 4 : 0);
  const int rank = (int)(blockIdx.x % (unsigned)k);
  const size_t c = blockIdx.x / (unsigned)k;
  const int l0 = rank * (B / k) + (int)threadIdx.x;
  const size_t row_meta = (size_t)chunks * 2 * kChunkBuckets;
  const ChunkRows<BITS, E, ACCUM> rows{words + c * BITS * B, (size_t)chunks * BITS * B, s_meta,
                                       raw == nullptr ? nullptr : raw + c * kChunkBuckets * B, own,
                                       ws, B, wire, i8_par, i8_scale};
  // Row 0's words are in flight while the meta is staged (a raw row 0 is
  // read in the fold).
  uint32_t w[BITS] = {};
  if (own != 0) load_words<BITS>(w, rows.wc, B, l0);
  for (int i = threadIdx.x; i < ws * 2 * kChunkBuckets; i += blockDim.x) {
    const int r = i / (2 * kChunkBuckets);
    s_meta[i] = meta[r * row_meta + c * 2 * kChunkBuckets + i % (2 * kChunkBuckets)];
  }
  __syncthreads();
  if constexpr (INT8) {
    if (threadIdx.x < kChunkBuckets) int8_prologue(s_meta, 2 * kChunkBuckets, ws, own, i8_par, i8_scale);
    __syncthreads();
  }
  float acc[kChunkBuckets];
  rows.fold(acc, w, l0);
  cluster_quantize<BITS, ENCODE, PACK, REREAD, STOCH>(acc, rows, k, rank, B, inv,
                                                      out_words + c * BITS * B,
                                                      out_meta + c * 2 * kChunkBuckets, stage,
                                                      chunk_stream(seed, c));
}

// ---------------------------------------------------------------------------
// The pipelined cluster kernels: B7a (cgx_quantize_db_cluster_kernel) and
// B7c (cgx_sra_epilogue_db_cluster_kernel). They replace
// codec_pallas.py _quantize_flat_db_impl and _sra_epilogue_db_impl.
//
// What bounds them: what bounds B1 and B3 (the cluster kernels above),
// whose launch shapes they share. The one-block-a-chunk body behind a ring
// of whole-chunk slots that they replace walked each bucket in a dependent
// loop, read a (32, B) tile in shared memory several times, ran one
// 512-thread block an SM (two whole-chunk slots of 64 KB at B = 512) and
// could not stage B >= 1024 at all.
//
// The design: B1's and B3's body, cluster_quantize, on a persistent grid.
//  - the cluster geometry is B1's and B3's (codec_cuda.db_geometry):
//    clusters of k CTAs, CTA `rank` owning positions [rank*B/k,
//    (rank+1)*B/k) of all 32 buckets, past the register budget (REREAD)
//    in rounds of T positions, here rounds of equal width, so that every
//    warp reads every item;
//  - G clusters (the most the card holds at once, at most the tiles) walk
//    the tiles: cluster g takes tiles g, g + G, ..., a tile `tc`
//    consecutive chunks; the k CTAs of a cluster take the same chunks in
//    lockstep (the cluster barrier that ends cluster_quantize ends each
//    chunk; after it a CTA's partials and parameters may be overwritten);
//  - each CTA streams only its own share through a ring of `slots` slots:
//    B7a a round of 32 segments of T floats (one a bucket), B7c a round of
//    one peer row's `bits` segments of T words and the row's 256 bytes of
//    chunk meta; warp 0 issues a slot's copies (one a lane) against one
//    expect_tx. Items go in the order the body reads them: without REREAD
//    one a chunk (B7c one a peer row), with it one a round for the
//    extremes and one a round again for the encode, the second read of a
//    value from the L2 as in B1 and B3;
//  - a thread copies its position of an item from the slot into registers
//    (B7c: decodes it and folds it into the 32 sums in ascending row
//    order, the raw own row read from device memory at its turn, as in
//    B3) and its warp releases the slot on the slot's `empty` barrier; once
//    every warp has, warp 0 refills it with item n + slots. So one B7a slot
//    and the registers double-buffer: the next chunk's share lands while
//    this one is reduced and encoded, and a 64 KB slot keeps two 512-thread
//    CTAs an SM. B7c's items are small (8.25 KB at 4 bits, B = 512), so
//    its ring holds several;
//  - every warp waits on every item, each slot's phases in order, and
//    releases it (one arrival a warp): an item cannot land in a slot until
//    every warp is done with the slot's last one, so no warp's wait can
//    mistake a phase two ahead for the one it waits on;
//  - registers: the body fills 64 a thread (two 512-thread CTAs an SM), so
//    the walk adds no division where values are live: the producer's
//    place in the walk is a cursor in shared memory advanced by
//    increments, the ring's depth a power of two (a mask and a shift), and
//    indices are 32-bit (the entry points check that a walk's items fit).
//    Even so the walk's loop keeps some registers live across the body,
//    and at 64 a thread it spills part of a thread's 32 values between
//    their loads from the slot and the reduce (PERF.md, section 6).
// ---------------------------------------------------------------------------

constexpr int kMaxSlots = 8;  // kBarBytes holds a full and an empty barrier for each

// One CTA's ring: 2^shift slots of `slot_bytes`, item n in slot n & mask
// for the (n >> shift)-th time. `full`: one arrival (the producer's
// expect_tx) and the bytes; `empty`: one arrival a warp of the CTA.
struct ShareRing {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* base;
  uint32_t slot_bytes;
  int shift;

  __device__ __forceinline__ int slots() const { return 1 << shift; }
  __device__ __forceinline__ unsigned char* slot(int n) const {
    return base + (size_t)(n & (slots() - 1)) * slot_bytes;
  }
  __device__ __forceinline__ void wait(int n) const {
    mbar_wait(&full[n & (slots() - 1)], (uint32_t)((n >> shift) & 1));
  }
  // This warp is done with item n.
  __device__ __forceinline__ void release(int n) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive_count(&empty[n & (slots() - 1)], 1);
  }
  // Before item n (n >= slots) goes into its slot: every warp has released
  // item n - slots.
  __device__ __forceinline__ void wait_empty(int n) const {
    mbar_wait(&empty[n & (slots() - 1)], (uint32_t)(((n >> shift) - 1) & 1));
  }
};

// Thread 0 initialises the ring of `slots` (a power of two) slots:
// barriers at the start of the dynamic shared memory, the slots after
// kBarBytes; every thread sees it after.
__device__ __forceinline__ ShareRing share_ring(unsigned char* smem, int slots,
                                                uint32_t slot_bytes) {
  ShareRing ring{reinterpret_cast<uint64_t*>(smem), reinterpret_cast<uint64_t*>(smem) + kMaxSlots,
                 smem + kBarBytes, slot_bytes, __ffs(slots) - 1};
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init_count(&ring.full[s], 1);
      mbar_init_count(&ring.empty[s], blockDim.x >> 5);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// A CTA's share of a chunk: positions [rank*span, (rank+1)*span), span =
// B/k, in `rounds` rounds of T (blockDim.x) positions, span = rounds*T;
// one round without REREAD. A chunk's round items: one, or with REREAD one
// a round for the extremes and one a round again for the encode.
template <bool REREAD>
struct Share {
  int span, T, rounds, rank;
  __device__ __forceinline__ int round_items() const { return REREAD ? 2 * rounds : 1; }
  // The round of round item ri.
  __device__ __forceinline__ int round_of(int ri) const {
    return REREAD ? (ri >= rounds ? ri - rounds : ri) : 0;
  }
};

template <bool REREAD>
__device__ __forceinline__ Share<REREAD> cta_share(int B, int k, int rank) {
  const int span = B / k, T = (int)blockDim.x;
  return Share<REREAD>{span, T, REREAD ? span / T : 1, rank};
}

// The producer's place in a persistent cluster's walk, kept in shared
// memory by warp 0: the next item to issue (n), its tile t (the cluster's
// tiles are g, g + G, ... below `tiles`), its chunk u of the tile (a tile
// is `tc` consecutive chunks), its round item ri and its peer row pr (B7c).
struct Cursor {
  int n, t, u, ri, pr;
};


// Warp 0: issue the item the cursor names, if the walk has one, into its
// slot once the slot is free, then advance the cursor. `copy(c, ri, pr,
// dst, bar)` issues the item's bulk copies (expect_tx included) for chunk
// c, round item ri, peer row pr.
template <typename Copy>
__device__ __forceinline__ void issue_next(Cursor* cur, const ShareRing& ring, int tiles, int tc,
                                           int G, int round_items, int peers, const Copy& copy) {
  Cursor c = *cur;
  if (c.t >= tiles) return;
  if (c.n >= ring.slots()) {
    ring.wait_empty(c.n);
    // The warps' reads of the slot (generic proxy) before the copy's
    // writes (async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  copy(c.t * tc + c.u, c.ri, c.pr, ring.slot(c.n), &ring.full[c.n & (ring.slots() - 1)]);
  ++c.n;
  if (++c.pr == peers) {
    c.pr = 0;
    if (++c.ri == round_items) {
      c.ri = 0;
      if (++c.u == tc) {
        c.u = 0;
        c.t += G;
      }
    }
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0) *cur = c;
  __syncwarp();
}

// B7a's loads: each call reads the chunk's next item, the round the body
// loads (rounds 0, 1, ... for the extremes, then again for the encode),
// position l's 32 values of it. `next`: the item; `issue()`: warp 0
// issues the ring's next item.
template <typename Issue, typename E>
struct RingValues {
  const ShareRing& ring;
  const Issue& issue;
  mutable int next;
  int wire;

  __device__ __forceinline__ void operator()(float (&v)[kChunkBuckets], int) const {
    const int n = next++;
    ring.wait(n);
    const E* src = reinterpret_cast<const E*>(ring.slot(n)) + threadIdx.x;
#pragma unroll
    for (int s = 0; s < kChunkBuckets; ++s) v[s] = wire_float(src[s * (int)blockDim.x], wire);
    ring.release(n);
    if ((threadIdx.x >> 5) == 0) issue();
  }
};

// codec_quantize_db (B7a) on the cluster geometry: a persistent grid of G
// clusters of k CTAs of T threads (see above); dynamic shared memory the
// ring's barriers, `slots` slots of 32*T*sizeof(E) bytes, then the
// butterfly stage (T/32 * 4096 bytes) or nothing. STOCH: rounded with the
// stream of `seed` at the chunk's global index, as B1. x: E values of the
// wire dtype `wire`, copied to the slots as they are and upcast where a
// thread reads them. A segment is T*sizeof(E) bytes at an offset of whole
// warps of positions (T, B/k and B are multiples of 32), so at 16-bit
// values too a bulk copy's size and both addresses are multiples of 16.
template <int BITS, int ENCODE, int PACK, bool REREAD, bool STOCH, typename E>
__global__ void __launch_bounds__(kClusterMaxThreads, REREAD ? 1 : kClusterMinBlocks)
    cgx_quantize_db_cluster_kernel(const E* __restrict__ x, int32_t* __restrict__ words,
                                   float* __restrict__ meta, int tiles, int tc, int B, int k,
                                   float inv, int slots, uint2 seed, int wire) {
  extern __shared__ __align__(128) unsigned char db_smem[];
  __shared__ Cursor s_cur;
  const int rank = (int)(blockIdx.x % (unsigned)k);
  const int g = (int)(blockIdx.x / (unsigned)k), G = (int)(gridDim.x / (unsigned)k);
  const Share<REREAD> sh = cta_share<REREAD>(B, k, rank);
  const uint32_t slot_bytes = (uint32_t)(kChunkBuckets * sh.T * sizeof(E));
  if (threadIdx.x == 0) s_cur = Cursor{0, g, 0, 0, 0};
  const ShareRing ring = share_ring(db_smem, slots, slot_bytes);
  uint32_t* stage = reinterpret_cast<uint32_t*>(db_smem + kBarBytes + (size_t)slots * slot_bytes);
  // An item: 32 segments (bucket s: lane s) of its round of chunk c.
  auto copy = [&](int c, int ri, int, unsigned char* dst, uint64_t* bar) {
    const int p = sh.round_of(ri);
    const uint32_t seg = (uint32_t)(sh.T * sizeof(E));
    const int lane = threadIdx.x & 31;
    if (lane == 0) mbar_expect_tx(bar, kChunkBuckets * seg);
    __syncwarp();
    bulk_load(dst + (size_t)lane * sh.T * sizeof(E),
              x + ((size_t)c * kChunkBuckets + lane) * B + sh.rank * sh.span + p * sh.T, seg, bar);
  };
  auto issue = [&]() { issue_next(&s_cur, ring, tiles, tc, G, sh.round_items(), 1, copy); };
  if (threadIdx.x < 32) {
    for (int n = 0; n < slots; ++n) issue();
  }
  int j = 0;
  for (int t = g; t < tiles; t += G) {
    for (int u = 0; u < tc; ++u, ++j) {
      const RingValues<decltype(issue), E> load{ring, issue, j * sh.round_items(), wire};
      float v[kChunkBuckets];
      load(v, sh.rank * sh.span + (int)threadIdx.x);
      const size_t c = (size_t)t * tc + u;
      cluster_quantize<BITS, ENCODE, PACK, REREAD, STOCH>(v, load, k, rank, B, inv,
                                                          words + c * BITS * B,
                                                          meta + c * 2 * kChunkBuckets, stage,
                                                          chunk_stream(seed, c));
    }
  }
}

// B7c's loads: each call folds position l of the ws rows in ascending row
// order, the peer rows from the chunk's next items (one a peer row, rows
// ascending, of the round the body loads), the raw own row (rawc, or
// null) from device memory, as ChunkRows does for B3, then rounds them
// through the wire dtype.
template <int BITS, typename Issue, typename E, int ACCUM = kAccumExact>
struct RingRows {
  const ShareRing& ring;
  const Issue& issue;
  mutable int next;
  const E* rawc;
  int own, ws, B, wire;
  const float4* i8_par;  // the int8 fold's parameters and scales (int8_prologue)
  const uint32_t* i8_scale;

  template <bool FIRST>
  __device__ __forceinline__ void row(float (&acc)[kChunkBuckets], uint32_t (&w)[BITS], bool raw,
                                      int l) const {
    if (raw) {
      fold_row<BITS, FIRST, E>(acc, w, nullptr, rawc, B, l, wire);
      return;
    }
    const int n = next++;
    ring.wait(n);
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(ring.slot(n));
    const int T = (int)blockDim.x;
#pragma unroll
    for (int b = 0; b < BITS; ++b) w[b] = sw[b * T + threadIdx.x];
    fold_row<BITS, FIRST, E>(acc, w, reinterpret_cast<const float*>(sw + BITS * T), nullptr, B, l,
                             wire);
    ring.release(n);
    if ((threadIdx.x >> 5) == 0) issue();
  }

  __device__ __forceinline__ void operator()(float (&acc)[kChunkBuckets], int l) const {
    uint32_t w[BITS];
    if constexpr (ACCUM == kAccumInt8) {
      uint32_t acc_i[kChunkBuckets];
#pragma unroll
      for (int s = 0; s < kChunkBuckets; ++s) acc_i[s] = 0u;
      const int T = (int)blockDim.x;
      for (int r = 0; r < ws; ++r) {
        if (r == own) continue;
        const int n = next++;
        ring.wait(n);
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(ring.slot(n));
#pragma unroll
        for (int b = 0; b < BITS; ++b) w[b] = sw[b * T + threadIdx.x];
        fold_row_int8<BITS>(acc_i, w, i8_scale + r * kChunkBuckets);
        ring.release(n);
        if ((threadIdx.x >> 5) == 0) issue();
      }
      int8_finish<E>(acc, acc_i, i8_par, rawc, B, l, wire);
    } else {
      row<true>(acc, w, own == 0, l);
      for (int r = 1; r < ws; ++r) row<false>(acc, w, r == own, l);
    }
    requant_cast<E>(acc, wire);
  }
};

// codec_sra_epilogue_db (B7c) on the cluster geometry: as B7a, the ring's
// slots each one peer row's round (bits*T*4 bytes of words, then 256 of
// meta). STOCH: rounded with the stream of `seed` at the output chunk's
// index, as B3. E, `wire`: the wire dtype, as B3's.
template <int BITS, int ENCODE, int PACK, bool REREAD, bool STOCH, typename E,
          int ACCUM = kAccumExact>
__global__ void __launch_bounds__(kClusterMaxThreads, REREAD ? 1 : kClusterMinBlocks)
    cgx_sra_epilogue_db_cluster_kernel(const int32_t* __restrict__ words,
                                       const float* __restrict__ meta,
                                       const E* __restrict__ raw, int own, int ws,
                                       int chunks, int tiles, int tc, int B, int k, float inv,
                                       int slots, int32_t* __restrict__ out_words,
                                       float* __restrict__ out_meta, uint2 seed, int wire) {
  extern __shared__ __align__(128) unsigned char db_smem[];
  __shared__ Cursor s_cur;
  const int rank = (int)(blockIdx.x % (unsigned)k);
  const int g = (int)(blockIdx.x / (unsigned)k), G = (int)(gridDim.x / (unsigned)k);
  const Share<REREAD> sh = cta_share<REREAD>(B, k, rank);
  const uint32_t slot_bytes = (uint32_t)((BITS * sh.T + 2 * kChunkBuckets) * sizeof(float));
  const int peers = ws - (own >= 0 ? 1 : 0);
  // With no peer row (one row, the raw own one) the walk has no items.
  if (threadIdx.x == 0) s_cur = Cursor{0, peers > 0 ? g : tiles, 0, 0, 0};
  const ShareRing ring = share_ring(db_smem, slots, slot_bytes);
  uint32_t* stage = reinterpret_cast<uint32_t*>(db_smem + kBarBytes + (size_t)slots * slot_bytes);
  // The int8 fold's parameters and scales of the chunk (int8_smem_bytes)
  // after the butterfly stage.
  float4* i8_par = reinterpret_cast<float4*>(
      stage + (PACK == kPackButterfly ? (size_t)(sh.T / 32) * 32 * 32 : 0));
  uint32_t* i8_scale = reinterpret_cast<uint32_t*>(i8_par + kChunkBuckets);
  // An item: peer row pr (ascending, the own row skipped) of round item ri
  // of chunk c, `bits` segments of its round (plane b: lane b) and the
  // row's meta of the chunk (lane bits).
  auto copy = [&](int c, int ri, int pr, unsigned char* dst, uint64_t* bar) {
    const int r = pr + (own >= 0 && pr >= own ? 1 : 0);
    const int p = sh.round_of(ri);
    const uint32_t seg = (uint32_t)(sh.T * sizeof(int32_t));
    const int lane = threadIdx.x & 31;
    const size_t rc = (size_t)r * chunks + c;
    if (lane == 0) mbar_expect_tx(bar, BITS * seg + 2 * kChunkBuckets * sizeof(float));
    __syncwarp();
    if (lane < BITS) {
      bulk_load(dst + (size_t)lane * sh.T * sizeof(int32_t),
                words + (rc * BITS + lane) * B + sh.rank * sh.span + p * sh.T, seg, bar);
    } else if (lane == BITS) {
      bulk_load(dst + (size_t)BITS * sh.T * sizeof(int32_t), meta + rc * 2 * kChunkBuckets,
                2 * kChunkBuckets * sizeof(float), bar);
    }
  };
  auto issue = [&]() { issue_next(&s_cur, ring, tiles, tc, G, sh.round_items(), peers, copy); };
  if (threadIdx.x < 32) {
    for (int n = 0; n < slots; ++n) issue();
  }
  const int chunk_items = sh.round_items() * peers;
  int j = 0;
  for (int t = g; t < tiles; t += G) {
    for (int u = 0; u < tc; ++u, ++j) {
      const size_t c = (size_t)t * tc + u;
      if constexpr (ACCUM == kAccumInt8) {
        // Every thread is done with the last chunk's parameters (with
        // REREAD its encode folds again) before warp 0 writes this one's,
        // from every row's meta in device memory (the own row's too).
        __syncthreads();
        if (threadIdx.x < kChunkBuckets) {
          int8_prologue(meta + c * 2 * kChunkBuckets, (size_t)chunks * 2 * kChunkBuckets, ws, own,
                        i8_par, i8_scale);
        }
        __syncthreads();
      }
      const RingRows<BITS, decltype(issue), E, ACCUM> rows{
          ring, issue, j * chunk_items, raw == nullptr ? nullptr : raw + c * kChunkBuckets * B,
          own, ws, B, wire, i8_par, i8_scale};
      float acc[kChunkBuckets];
      rows(acc, sh.rank * sh.span + (int)threadIdx.x);
      cluster_quantize<BITS, ENCODE, PACK, REREAD, STOCH>(acc, rows, k, rank, B, inv,
                                                          out_words + c * BITS * B,
                                                          out_meta + c * 2 * kChunkBuckets, stage,
                                                          chunk_stream(seed, c));
    }
  }
}

// ---------------------------------------------------------------------------
// The matmul-quantize on tensor cores: B8's 16-bit operands, and its
// float32 operands as split TF32 fed by a split-transpose pass.
// ---------------------------------------------------------------------------

constexpr int kTcBM = 128;  // rows of dw (columns of x2) a tile covers: 64 a consumer warpgroup
constexpr int kTcBN = 192;  // columns of dw (of g2) a tile covers: one m64n192 wgmma wide
constexpr int kTcBK = 64;   // 16-bit contraction steps a ring stage holds: four k16 steps
constexpr int kTcStages = 5;
constexpr int kTcBox = 64;  // a TMA box's columns: 128 bytes, the 128-byte swizzle's width
constexpr int kTcBoxBytes = kTcBK * kTcBox * 2;                 // one box: 64 rows of 128 bytes
constexpr int kTcStageBytes = (kTcBM + kTcBN) / kTcBox * kTcBoxBytes;  // x2's 2 boxes, g2's 3
constexpr int kTcConsumers = 256;                // two warpgroups
constexpr int kTcThreads = kTcConsumers + 32;    // and the producer warp
constexpr int kTcSwizzleBytes = 1024;            // 8 rows of 128 bytes: the swizzle's period
// The float32 operands' ring: K-major planes (hi, then lo) of the split
// operands, 32 contraction steps (128 bytes) a row, so a stage holds
// 2 x (128 + 192) rows of 128 bytes: 80 KB, two stages.
constexpr int kTf32BK = 32;
constexpr int kTf32Stages = 2;
constexpr int kTf32XBytes = kTcBM * kTf32BK * 4;  // one plane of x2's tile: 16 KB
constexpr int kTf32GBytes = kTcBN * kTf32BK * 4;  // one plane of g2's tile: 24 KB
constexpr int kTf32StageBytes = 2 * (kTf32XBytes + kTf32GBytes);
// The split-TF32 kernel's k8 steps whose three products a partial sums
// before the CUDA cores add it to the sums (16 contraction steps).
constexpr int kTf32PartialSteps = 2;
constexpr int kSplitTile = 32;   // the split pass's tile: contraction rows
constexpr int kSplitCols = 128;  // and columns

// The ring of one operand form: E = uint16_t, MN-major 16-bit boxes; E =
// float, the K-major split-TF32 planes.
template <typename E>
struct TcRing {
  static constexpr int kBK = kTcBK, kStages = kTcStages, kStageBytes = kTcStageBytes;
};
template <>
struct TcRing<float> {
  static constexpr int kBK = kTf32BK, kStages = kTf32Stages, kStageBytes = kTf32StageBytes;
};

// A wgmma shared-memory descriptor of an MN-major operand in the 128-byte
// swizzle at shared address `addr` (a multiple of 1,024): 8 contraction
// rows of 128 bytes (64 values along M or N) an atom; the leading byte
// offset steps to the next 64 values along M or N (the next TMA box), the
// stride byte offset to the next 8 contraction rows.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(kTcBoxBytes >> 4) << 16) |
         ((uint64_t)(kTcSwizzleBytes >> 4) << 32) | (1ull << 62);
}

// The descriptor of a K-major operand in the 128-byte swizzle: rows of 128
// bytes (32 tf32 values along K), 8 rows an atom of 1,024 bytes; the
// stride byte offset steps to the next 8 rows along M or N, the leading
// one is unused (1) in a swizzled K-major layout. A k8 step 32 bytes into
// the row is `addr` + 32 (the swizzle is a function of the address).
__device__ __forceinline__ uint64_t gmma_desc_kmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(kTcSwizzleBytes >> 4) << 32) | (1ull << 62);
}

// d += A B for a warpgroup's 64 x 192 f32 sums (d = A B with scale_d 0):
// SHAPE names the contraction and the operand types, TAIL the immediate
// scales (and, for 16-bit operands, the transpose flags).
#define CGX_WGMMA_M64N192(SHAPE, TAIL)                                                        \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned." SHAPE " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                                    \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "                          \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "                          \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                          \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                          \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "                          \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "                          \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "                         \
      "%96, %97, p" TAIL ";\n}\n"                                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),         \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),         \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),         \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),         \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),         \
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),         \
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),         \
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),         \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),         \
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])                       \
      : "l"(da), "l"(db), "r"(scale_d))

// 16 contraction steps of bf16 or f16 (WIRE), A and B both MN-major (the
// transpose flags 1).
template <int WIRE>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da, uint64_t db,
                                                 int scale_d) {
  if constexpr (WIRE == kWireF16) {
    CGX_WGMMA_M64N192("m64n192k16.f32.f16.f16", ", 1, 1, 1, 1");
  } else {
    CGX_WGMMA_M64N192("m64n192k16.f32.bf16.bf16", ", 1, 1, 1, 1");
  }
}

#define CGX_WGMMA_M64N96(SHAPE, TAIL)                                                         \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned." SHAPE " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                                    \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "                          \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "                          \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "                          \
      "%48, %49, p" TAIL ";\n}\n"                                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),         \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),         \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])                       \
      : "l"(da), "l"(db), "r"(scale_d))

// d += A B for a warpgroup's 64 x 96 f32 sums over 8 contraction steps of
// tf32, A and B both K-major (the tf32 form takes no transpose flags).
__device__ __forceinline__ void wgmma_m64n96k8_tf32(float (&d)[48], uint64_t da, uint64_t db,
                                                    int scale_d) {
  CGX_WGMMA_M64N96("m64n96k8.f32.tf32.tf32", ", 1, 1");
}
#undef CGX_WGMMA_M64N96
#undef CGX_WGMMA_M64N192

// Keeps the compiler from moving reads or writes of the sums across the
// wgmma fences and waits (the asynchronous product owns the registers).
template <int N>
__device__ __forceinline__ void wgmma_fence_sums(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// x / div correctly rounded, bit for bit __fdiv_rn(x, div): the product
// with rdiv = 1/div where div is a power of two (the product is then the
// exact quotient rounded once), else the IEEE divide (rdiv 0).
__device__ __forceinline__ float div_by(float x, float div, float rdiv) {
  return rdiv != 0.f ? __fmul_rn(x, rdiv) : __fdiv_rn(x, div);
}

// One TMA box of the 2-D tensor `map` at (column c0, row c1) into shared
// memory at dst, completing on `bar` (its bytes announced beforehand).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// The same for a 3-D tensor, at (c0, c1, plane c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero
// (cvt.rna.tf32.f32), its 13 low bits cleared so that the bytes are the
// plain version's (codec_cuda.tf32_round_plain) whatever the convert
// leaves there; the tensor cores ignore them.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// codec_tf32_split: the float32 operands of the split-TF32 matmul-quantize
// (part of B8, fused_producer.py _matmul_quantize_impl; no TPU kernel of
// its own: the TPU kernel reads its float32 operands as they are). x2 (K,
// din) and g2 (K, o), row-major, become K-major planes of their transposes,
// K padded with zeros to kp (a multiple of the ring stage, kTf32BK):
// xs[0] = hi(x2^T), xs[1] = lo(x2^T), (din, kp) each, and gs likewise
// (o, kp), with hi = tf32_rna(x) and lo = tf32_rna(x - hi) (x - hi is
// exact in f32). So hi + lo is x within 2^-22 |x|, and an integer below
// 2^11 in magnitude has lo = 0.
//
// Bound: bytes, 4K(din + o) read once and 8kp(din + o) written (15.7 MB
// and 31.5 MB at GPT-2 124M's mlp_in, 0.014 ms at 3.35 TB/s). The design:
// a tile of 32 contraction rows x 128 columns a block, 256 threads; a
// warp reads a row's 128 columns as 16-byte loads (512 contiguous bytes;
// 4-byte loads where the row is not 16-byte aligned or the columns not a
// multiple of 4), through a shared tile padded to 129 columns (no bank
// conflict on the transposed read), and writes each column's 32
// contraction steps, 128 contiguous bytes a warp a plane. One launch
// serves both operands: blocks [0, x_tiles) take x2's column tiles, the
// rest g2's; blockIdx.y walks the contraction tiles. Its output stays in
// the L2 (31.5 MB of 50) for the GEMM that reads it next.
#if !defined(CGX_PART) || CGX_PART == 22  // built with its entry point alone
__global__ void __launch_bounds__(256)
    cgx_tf32_split_kernel(const float* __restrict__ x2, const float* __restrict__ g2,
                          long long k_total, int din, int o, long long kp, int x_tiles, int x_vec,
                          int g_vec, float* __restrict__ xs, float* __restrict__ gs) {
  __shared__ float tile[kSplitTile][kSplitCols + 1];
  int ct = blockIdx.x;
  const float* src = x2;
  float* dst = xs;
  int cols = din, vec = x_vec;
  if (ct >= x_tiles) {
    ct -= x_tiles;
    src = g2;
    dst = gs;
    cols = o;
    vec = g_vec;
  }
  const int c0 = ct * kSplitCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t plane = (size_t)cols * kp;
  for (long long k0 = (long long)blockIdx.y * kSplitTile; k0 < kp;
       k0 += (long long)gridDim.y * kSplitTile) {
#pragma unroll
    for (int r = warp; r < kSplitTile; r += 8) {  // row k0 + r, columns c0 + 4 lane ..
      const long long k = k0 + r;
      const int c = c0 + 4 * lane;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (k < k_total) {
        const float* row = src + k * cols;
        if (vec && c < cols) {  // cols % 4 == 0: the four lie in the row
          const float4 q = *reinterpret_cast<const float4*>(row + c);
          v[0] = q.x;
          v[1] = q.y;
          v[2] = q.z;
          v[3] = q.w;
        } else if (!vec) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = c + e < cols ? row[c + e] : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) tile[r][4 * lane + e] = v[e];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = warp; j < kSplitCols; j += 8) {  // column c0 + j, contraction step k0 + lane
      const int c = c0 + j;
      if (c < cols) {
        const float v = tile[lane][j];
        const float hi = tf32_rna(v);
        const size_t at = (size_t)c * kp + k0 + lane;
        dst[at] = hi;
        dst[plane + at] = tf32_rna(__fsub_rn(v, hi));
      }
    }
    __syncthreads();  // the tile is free for the next contraction tile
  }
}
#endif

// codec_matmul_quantize on tensor cores. Replaces fused_producer.py
// _matmul_quantize_impl (B8) for bf16 and f16 operands wherever TMA can
// describe them (din and o multiples of 8, both operands 16-byte aligned:
// codec_cuda.mm_tc_eligible; other 16-bit shapes take
// cgx_matmul_quantize_kernel above), and for every float32 operand pair
// the FFMA kernel takes, as split TF32 (cgx_matmul_quantize_tf32_kernel,
// below). The function is the FFMA kernel's: dw = x2^T g2 summed in f32,
// __fdiv_rn by div, quantized in the wire layout of the flat dw, the own
// raw row each sum rounded to the operand dtype (float32: the sum
// itself), then divided. Both kernels are this body, E the operand type
// (WIRE the 16-bit format, a template parameter: the two formats are
// different wgmma instructions).
//
// Bound: operations, 2*K*din*o at the bf16 tensor-core rate (989 TFLOP/s
// dense), against 2*K*(din + o) bytes read once and n*bits/8 + 8n/B (+
// 4n/ws of the raw row) written: 0.0049 ms at GPT-2 124M's mlp_in (K =
// 1,024), the bytes alone about 3.4 us. The FFMA design reached 2 % of
// that, issue-bound on its f32 FMAs and the converts at the shared-memory
// read. For float32 operands: three products a step at the TF32 rate (495
// TFLOP/s), 3 x 4.83 GFLOP in 0.0293 ms at mlp_in, against the FFMA
// ceiling's 0.0721 (67 TFLOP/s). The design:
//  - the mainloop is wgmma.mma_async m64n192, both operands read from
//    shared memory. 16-bit: k16 steps; x2^T (din contiguous) and g2 (o
//    contiguous) are both MN-major, which the 16-bit wgmma takes through
//    its transpose flags, so no pass transposes them; gmma_desc describes
//    them. float32: the tf32 wgmma (k8) takes no transpose flags, both
//    operands K-major, so cgx_tf32_split_kernel writes the K-major hi and
//    lo planes of x2^T and g2^T first, and each k8 step runs three
//    wgmma, the small terms first: lo(x) hi(g), hi(x) lo(g), then hi(x)
//    hi(g); lo lo (about 2^-22 of a product) is dropped. Each wgmma
//    rounds its sum into the accumulator once, and a first version's
//    three a k8 step into one accumulator over all of K moved the meta past
//    chip_smoke.py's META_RTOL (1e-5) at K = 1,024, more the longer K.
//    So the 6 wgmma of 16 contraction steps of a 96-column half of the
//    tile (m64n96k8) sum into a partial from zero, and the CUDA cores add
//    it to the 96 sums a thread keeps, rounded to nearest (__fadd_rn): 64
//    rounded adds at K = 1,024, each partial's roundings relative to its
//    own magnitude (tools/tf32_accuracy.py holds 8, 16 and 32 steps a
//    partial to the float64 product on phase 7's operands; PERF.md). It
//    costs 48 registers for the partial (the instances use 168 a thread
//    and spill a little: PERF.md), a drain of the wgmma queue a partial (the
//    other warpgroup keeps the tensor cores busy), and 96 adds a thread
//    16 steps. gmma_desc_kmajor describes the planes;
//  - a tile is 128 x 192 of dw: two consumer warpgroups, 64 rows each, 96
//    sums a thread (96, 72 and 96 tiles at GPT-2 124M's mlp_in, attn_qkv
//    and mlp_out: one wave of the persistent grid on 132 SMs; 128 x 128
//    tiles would give 144, 108 and 144, two waves at mlp_in and mlp_out);
//  - one producer warp keeps the ring full, one full and one empty
//    mbarrier a stage, in the 128-byte swizzle wgmma reads. 16-bit: 5
//    stages of 64 contraction rows, per stage two TMA boxes of x2 and
//    three of g2, 64 values x 64 rows each. float32: 2 stages of 32
//    contraction steps (the 128-byte swizzle's row), per stage the hi and
//    lo boxes of x2's 128 rows and g2's 192 (80 KB; two stages, 160 KB,
//    fit the block's 227 KB beside a chunk's tile, three would not). TMA
//    fills the parts of a box past din or o (and, 16-bit, K) with zeros,
//    and the split pass pads K with zeros, so the tails cost the mainloop
//    nothing; only the workspace stores are masked. The consumers keep
//    one stage's products in flight (wgmma.wait_group 1) and release the
//    stage before it (float32: every wgmma of a stage is done before the
//    last adds, and the stage is released after them);
//  - no setmaxnreg: the consumers' 96 sums fit the 224 registers a thread
//    that one block of 288 threads an SM allows, and every warp, the
//    producer's too, runs the chunk quantize after the tiles;
//  - the sums are the tensor cores': every product is exact in f32 (a
//    split plane's value has 11 significant bits) and the sums are f32, in
//    the tensor cores' order, so on small-integer operands (every partial
//    sum exact; below 2^11 the lo planes are zero) the bytes equal the
//    plain version's, and on others words and meta agree within the
//    tolerance the f32 kernel keeps with cuBLAS (chip_smoke.py
//    payload_close). A nonfinite float32 operand gives NaN sums where the
//    FFMA kernel's may be +-inf (lo = inf - inf);
//  - the epilogue is cgx_matmul_quantize_kernel's completion through the
//    L2 unchanged: each tile stores sum / div into the workspace (__stcg)
//    and the raw own row where it falls, fences, and adds to the chunks'
//    arrival counters; chunk c's block (c % gridDim.x) waits for its
//    arrivals, stages it in the ring's space and runs chunk_meta and
//    chunk_encode on it. The wire bytes of a given f32 dw are B1's. The
//    quotient is __fdiv_rn's, by a multiply where div is a power of two
//    (div_by; the IEEE divide's call is a sixth of the stores' time);
//  - where the rest goes (tools/mmtc_split.py times the kernel without its
//    quantize, and without its stores too; PERF.md): the mainloop (96
//    tiles on 132 SMs at mlp_in), the stores, and the chunk quantize, whose
//    encode is latency-bound at 9 warps an SM and takes two rounds where
//    the chunks (144 at mlp_in) outnumber the blocks. The float32
//    mainloop reads four planes, 2.5 MB of tiles from the L2 a tile at
//    mlp_in (252 MB a launch): the L2, not the tensor cores, bounds it.
template <int BITS, int ENCODE, int PACK, int WIRE, typename E>
__device__ __forceinline__ void matmul_quantize_tc_body(
    const CUtensorMap* x_map, const CUtensorMap* g_map, long long k_total, int din, int o,
    int tiles_n, long long tiles, float div, float rdiv, int B, float inv, float* __restrict__ work,
    int* __restrict__ arrivals, float* __restrict__ raw, long long raw_lo, long long raw_n,
    int32_t* __restrict__ words, float* __restrict__ meta) {
  using Ring = TcRing<E>;
  constexpr bool kTf32 = sizeof(E) == 4;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  __shared__ uint64_t full[Ring::kStages], empty[Ring::kStages];
  __shared__ float s_unit[kChunkBuckets];
  __shared__ float s_min[kChunkBuckets];
  // The swizzle's period is 1,024 bytes: the ring starts on one (the
  // launch asks for that much more).
  uint8_t* ring = tc_smem + ((kTcSwizzleBytes - (smem_addr(tc_smem) & (kTcSwizzleBytes - 1))) &
                             (kTcSwizzleBytes - 1));
  const int nk = (int)((k_total + Ring::kBK - 1) / Ring::kBK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Ring::kStages; ++s) {
      mbar_init_count(&full[s], 1);
      mbar_init_count(&empty[s], kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    // The producer warp: lane 0 walks the block's tiles' stages.
    if (threadIdx.x == kTcConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int i0 = (int)(t / tiles_n) * kTcBM;
        const int j0 = (int)(t % tiles_n) * kTcBN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);  // a fresh ring's first pass does not wait
          uint8_t* st = ring + stage * Ring::kStageBytes;
          mbar_expect_tx(&full[stage], Ring::kStageBytes);
          if constexpr (kTf32) {
#pragma unroll
            for (int p = 0; p < 2; ++p) {  // the hi plane, then the lo plane
              tma_load_3d(st + p * kTf32XBytes, x_map, kb * kTf32BK, i0, p, &full[stage]);
              tma_load_3d(st + 2 * kTf32XBytes + p * kTf32GBytes, g_map, kb * kTf32BK, j0, p,
                          &full[stage]);
            }
          } else {
#pragma unroll
            for (int b = 0; b < kTcBM / kTcBox; ++b) {
              tma_load_2d(st + b * kTcBoxBytes, x_map, i0 + b * kTcBox, kb * kTcBK, &full[stage]);
            }
#pragma unroll
            for (int b = 0; b < kTcBN / kTcBox; ++b) {
              tma_load_2d(st + (kTcBM / kTcBox + b) * kTcBoxBytes, g_map, j0 + b * kTcBox,
                          kb * kTcBK, &full[stage]);
            }
          }
          if (++stage == Ring::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
  } else {
    // The consumers: warpgroup wg sums rows 64wg .. 64wg + 63 of the tile.
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    float acc[96];
    float part[kTf32 ? 48 : 1];  // float32: the stage's sums of 96 columns
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.f;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int i0 = (int)(t / tiles_n) * kTcBM;
      const int j0 = (int)(t % tiles_n) * kTcBN;
      if constexpr (kTf32) {
#pragma unroll
        for (int i = 0; i < 96; ++i) acc[i] = 0.f;
      }
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        if constexpr (kTf32) {
          // wg's 64 rows of x2's planes (128 bytes a row), g2's 192 rows,
          // 96 columns of dw at a time: each 16 contraction steps' 6
          // products into `part` from zero, then added to the sums with
          // one rounding.
          const uint32_t xh = smem_addr(ring + stage * Ring::kStageBytes) + wg * 64 * 128;
          const uint32_t xl = xh + kTf32XBytes;
          const uint32_t gh = smem_addr(ring + stage * Ring::kStageBytes) + 2 * kTf32XBytes;
          const uint32_t gl = gh + kTf32GBytes;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t ghh = gh + half * 96 * 128, glh = gl + half * 96 * 128;
#pragma unroll
            for (int s0 = 0; s0 < kTf32BK / 8; s0 += kTf32PartialSteps) {
              wgmma_fence_sums(part);
              wgmma_fence();
#pragma unroll
              for (int s = s0; s < s0 + kTf32PartialSteps; ++s) {  // 8 steps (32 bytes) a wgmma
                wgmma_m64n96k8_tf32(part, gmma_desc_kmajor(xl + 32 * s),
                                    gmma_desc_kmajor(ghh + 32 * s), s > s0);
                wgmma_m64n96k8_tf32(part, gmma_desc_kmajor(xh + 32 * s),
                                    gmma_desc_kmajor(glh + 32 * s), 1);
                wgmma_m64n96k8_tf32(part, gmma_desc_kmajor(xh + 32 * s),
                                    gmma_desc_kmajor(ghh + 32 * s), 1);
              }
              wgmma_commit();
              wgmma_wait<0>();
              wgmma_fence_sums(part);
#pragma unroll
              for (int i = 0; i < 48; ++i) acc[48 * half + i] = __fadd_rn(acc[48 * half + i], part[i]);
            }
          }
          mbar_arrive_count(&empty[stage], 1);
        } else {
          wgmma_fence_sums(acc);
          wgmma_fence();
          const uint32_t a = smem_addr(ring + stage * kTcStageBytes + wg * kTcBoxBytes);
          const uint32_t b = smem_addr(ring + stage * kTcStageBytes + kTcBM / kTcBox * kTcBoxBytes);
#pragma unroll
          for (int s = 0; s < kTcBK / 16; ++s) {  // 16 rows of 128 bytes a step
            wgmma_m64n192k16<WIRE>(acc, gmma_desc(a + s * 2048), gmma_desc(b + s * 2048),
                                   kb > 0 || s > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done: release it
          wgmma_fence_sums(acc);
          if (kb > 0) mbar_arrive_count(&empty[prev], 1);
          prev = stage;
        }
        if (++stage == Ring::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if constexpr (!kTf32) {
        wgmma_wait<0>();
        wgmma_fence_sums(acc);
        mbar_arrive_count(&empty[prev], 1);
      }

      // The tile's values of dw / div into the workspace (and the raw
      // row): sum 4j + 2h + e of a thread is row 16 warp + lane/4 + 8h,
      // column 8j + 2 (lane % 4) + e of its warpgroup's 64 x 192.
      const int row0 = i0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < kTcBN / 8; ++j) {
        const int col = j0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < din && col < o) {  // o is even: col + 1 < o too
            const float s0 = acc[4 * j + 2 * h], s1 = acc[4 * j + 2 * h + 1];
            const long long flat = (long long)row * o + col;
            __stcg(reinterpret_cast<float2*>(work + flat),
                   make_float2(div_by(s0, div, rdiv), div_by(s1, div, rdiv)));
            if (flat >= raw_lo && flat < raw_lo + raw_n) {  // the product in the compute dtype, then / div
              *reinterpret_cast<float2*>(raw + (flat - raw_lo)) =
                  make_float2(div_by(wire_round<E>(s0, WIRE), div, rdiv),
                              div_by(wire_round<E>(s1, WIRE), div, rdiv));
            }
          }
        }
      }
      __threadfence();  // the values are visible device-wide before any arrival counts them
      asm volatile("bar.sync 1, %0;\n" ::"n"(kTcConsumers) : "memory");  // every consumer's values
      // One arrival per row of the tile, as cgx_matmul_quantize_kernel's.
      const int j1 = min(j0 + kTcBN, o);
      if (threadIdx.x < kTcBM && i0 + (int)threadIdx.x < din) {
        const int i = i0 + threadIdx.x;
        const long long chunk_n = (long long)kChunkBuckets * B;
        long long lo = (long long)i * o + j0;
        const long long hi = (long long)i * o + j1;
        while (lo < hi) {
          const long long c = lo / chunk_n;
          const long long end = min(hi, (c + 1) * chunk_n);
          atomicAdd(arrivals + c, (int)(end - lo));
          lo = end;
        }
      }
    }
  }

  // Every warp: this block's chunks, as cgx_matmul_quantize_kernel's. The
  // ring is free (every stage was consumed) and becomes the chunk's tile.
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* tile = reinterpret_cast<float*>(ring);
  const long long chunk_n = (long long)kChunkBuckets * B;
  const long long chunks = (long long)din * o / chunk_n;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    if (threadIdx.x == 0) {
      while (ld_acquire(arrivals + c) < chunk_n) __nanosleep(128);
    }
    __syncthreads();
    const float* src = work + c * chunk_n;
    for (long long e = threadIdx.x; e < chunk_n / 4; e += kTcThreads) {
      cp_async16(tile + 4 * e, src + 4 * e, 16);  // from the L2, where the values are
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    chunk_meta<ENCODE>(tile, B, inv, s_unit, s_min, meta + c * 2 * kChunkBuckets);
    __syncthreads();
    chunk_encode<BITS, ENCODE, PACK>(tile, B, s_unit, s_min, words + c * BITS * B);
    __syncthreads();  // the tile and the meta are free for the next chunk
  }
}

// B8's 16-bit operands: x_map and g_map the row-major operands' 2-D maps.
template <int BITS, int ENCODE, int PACK, int WIRE, typename E>
__global__ void __launch_bounds__(kTcThreads, 1)
    cgx_matmul_quantize_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                                  const __grid_constant__ CUtensorMap g_map, long long k_total,
                                  int din, int o, int tiles_n, long long tiles, float div,
                                  float rdiv, int B, float inv, float* __restrict__ work,
                                  int* __restrict__ arrivals,
                                  float* __restrict__ raw, long long raw_lo, long long raw_n,
                                  int32_t* __restrict__ words, float* __restrict__ meta) {
  matmul_quantize_tc_body<BITS, ENCODE, PACK, WIRE, E>(&x_map, &g_map, k_total, din, o, tiles_n,
                                                       tiles, div, rdiv, B, inv, work, arrivals,
                                                       raw, raw_lo, raw_n, words, meta);
}

// B8's float32 operands as split TF32: x_map and g_map the 3-D maps of the
// split pass's (2, din, kp) and (2, o, kp) planes, k_total = kp.
template <int BITS, int ENCODE, int PACK>
__global__ void __launch_bounds__(kTcThreads, 1)
    cgx_matmul_quantize_tf32_kernel(const __grid_constant__ CUtensorMap x_map,
                                    const __grid_constant__ CUtensorMap g_map, long long k_total,
                                    int din, int o, int tiles_n, long long tiles, float div,
                                    float rdiv, int B, float inv, float* __restrict__ work,
                                    int* __restrict__ arrivals, float* __restrict__ raw,
                                    long long raw_lo, long long raw_n,
                                    int32_t* __restrict__ words, float* __restrict__ meta) {
  matmul_quantize_tc_body<BITS, ENCODE, PACK, kWireF32, float>(
      &x_map, &g_map, k_total, din, o, tiles_n, tiles, div, rdiv, B, inv, work, arrivals, raw,
      raw_lo, raw_n, words, meta);
}

#ifndef CGX_INT8  // the divide check runs from the default library alone
// The divide check (not a codec kernel): for divisors d = (1 + m/2^23) *
// 2^e2 with m = m0, m0 + m_step, ... < 2^23, numerators around every
// level boundary and level of the domain (RN((t/2) * d) and its `ulps`
// neighbours on each side, t = 0 .. 2*2^8 + 1) and `extra` pseudo-random
// ones in [0, 2^8 * d), and the numerator guard's edge (2^-62 and its
// neighbours). counts: [0] the pairs tried; [1] those whose div_quotient
// differs in any bit from __fdiv_rn; [2] those whose 8-bit level differs;
// [3] nonzero once first[0..1] holds one pair (a, d) counted in [1] or [2].
__global__ void cgx_div_sweep_kernel(int e2, int m0, int m_step, int ulps, int extra,
                                     unsigned long long* counts, float* first) {
  unsigned long long tried = 0, qdiff = 0, ldiff = 0;
  const int n_m = ((1 << 23) - m0 + m_step - 1) / m_step;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_m; i += gridDim.x * blockDim.x) {
    const int m = m0 + i * m_step;
    const float d = __int_as_float(((127 + e2) << 23) | m);
    const float rcp = div_reciprocal(d);
    const uint32_t slow = div_slow_bits(d);
    auto check = [&](float a) {
      const float fast = div_quotient(a, d, rcp, slow);
      const float ref = __fdiv_rn(a, d);
      const uint32_t lf =
          level_cluster<8, kEncodeDiv>(a, make_float4(d, rcp, 0.f, __uint_as_float(slow)));
      const uint32_t lr = (uint32_t)fminf(fmaxf(floorf(__fadd_rn(ref, 0.5f)), 0.f), 255.f);
      ++tried;
      const bool qd = __float_as_int(fast) != __float_as_int(ref);
      qdiff += qd;
      ldiff += lf != lr;
      if ((qd || lf != lr) && atomicCAS(&counts[3], 0ull, 1ull) == 0ull) {
        first[0] = a;
        first[1] = d;
      }
    };
    for (int t = 0; t <= 2 * 256 + 1; ++t) {
      const float a0 = __fmul_rn(0.5f * (float)t, d);
      float up = a0, dn = a0;
      check(a0);
      for (int u = 0; u < ulps; ++u) {
        up = nextafterf(up, __int_as_float(0x7f800000));
        dn = nextafterf(dn, 0.f);
        check(up);
        check(dn);
      }
    }
    const float lo = __uint_as_float(kRcpMinNumeratorBits);
    check(lo);
    check(nextafterf(lo, 0.f));
    check(nextafterf(lo, 1.f));
    uint32_t h = 0x9e3779b9u * (uint32_t)(m + 1) ^ (uint32_t)e2;
    for (int t = 0; t < extra; ++t) {
      h ^= h << 13;
      h ^= h >> 17;
      h ^= h << 5;
      check(__fmul_rn(__fmul_rn((float)(h >> 8), 1.f / 16777216.f), __fmul_rn(256.f, d)));
    }
  }
  atomicAdd(&counts[0], tried);
  atomicAdd(&counts[1], qdiff);
  atomicAdd(&counts[2], ldiff);
}

// The divide check on given pairs: q_fast[i] = div_quotient(a, d, rcp of
// d), q_ref[i] = __fdiv_rn(a, d).
__global__ void cgx_div_pairs_kernel(const float* __restrict__ a, const float* __restrict__ d, int n,
                                     float* __restrict__ q_fast, float* __restrict__ q_ref) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    q_fast[i] = div_quotient(a[i], d[i], div_reciprocal(d[i]), div_slow_bits(d[i]));
    q_ref[i] = __fdiv_rn(a[i], d[i]);
  }
}
#endif  // CGX_INT8

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

// The reduce's row count as the constant ROWS: 1..8, else 0 (any count).
#define CGX_DISPATCH_ROWS(ws, ...)          \
  switch (ws) {                             \
    case 1: { constexpr int ROWS = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int ROWS = 2; __VA_ARGS__; } break; \
    case 3: { constexpr int ROWS = 3; __VA_ARGS__; } break; \
    case 4: { constexpr int ROWS = 4; __VA_ARGS__; } break; \
    case 5: { constexpr int ROWS = 5; __VA_ARGS__; } break; \
    case 6: { constexpr int ROWS = 6; __VA_ARGS__; } break; \
    case 7: { constexpr int ROWS = 7; __VA_ARGS__; } break; \
    case 8: { constexpr int ROWS = 8; __VA_ARGS__; } break; \
    default: { constexpr int ROWS = 0; __VA_ARGS__; } break; \
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


// Dynamic shared memory of a cluster kernel's butterfly stage: 32 x 32
// words a warp.
size_t stage_bytes(int pack, int threads) {
  return pack == kPackButterfly ? (size_t)(threads / 32) * 32 * 32 * sizeof(uint32_t) : 0;
}

// The geometries the cluster kernels take (codec_cuda.cluster_geometry
// picks one): k in {1, 2, 4, 8} CTAs a chunk, each B/k positions in whole
// warps, `threads` threads a CTA in whole warps of at most 512 and at most
// B/k (fewer than B/k: REREAD, the positions in rounds), so the chunk's B
// positions are covered exactly once, and a grid of chunks*k CTAs.
bool cluster_geometry_ok(long long chunks, int B, int k, int threads) {
  return (k == 1 || k == 2 || k == 4 || k == kClusterMaxSize) && B % (32 * k) == 0 &&
         threads >= 32 && threads <= kClusterMaxThreads && threads % 32 == 0 &&
         threads <= B / k && chunks * k <= 0x7fffffffLL;
}

// Launch `kernel` on chunks*k CTAs of `threads` in clusters of k (k = 1: a
// plain launch, no cluster). A refused launch is returned, and cleared from
// the runtime's last error so that it does not surface at a later launch.
template <typename... Params, typename... Args>
cudaError_t cluster_launch(void (*kernel)(Params...), long long chunks, int k, int threads,
                           size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(chunks * k));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = k > 1 ? 1 : 0;
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  if (e != cudaSuccess) (void)cudaGetLastError();
  return e;
}

// Launch the pipelined cluster `kernel` (B7a, B7c) as a persistent grid:
// G clusters of k CTAs of `threads` (k = 1: plain CTAs, no cluster), G the
// clusters the card holds at once at `smem` bytes of dynamic shared memory
// (the occupancy query for the cluster shape), at most `tiles`. A refused
// query or launch is returned and cleared, as cluster_launch does.
template <typename... Params, typename... Args>
cudaError_t persistent_cluster_launch(void (*kernel)(Params...), long long tiles, int k,
                                      int threads, size_t smem, cudaStream_t st, Args... args) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Always: the default allowance is 48 KB less the kernel's static
  // shared memory, which the ring and stage can pass below 48 KB.
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(k * sms));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = k > 1 ? 1 : 0;
  long long resident = 0;
  if (e == cudaSuccess) {
    int n = 0;
    if (k > 1) {
      e = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
      resident = n;
    } else {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
      resident = (long long)n * sms;
    }
  }
  if (e == cudaSuccess && resident < 1) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess) {
    cfg.gridDim = dim3((unsigned)((tiles < resident ? tiles : resident) * k));
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  if (e != cudaSuccess) (void)cudaGetLastError();
  return e;
}

// The pipelined cluster kernels' arguments: the cluster geometry as the
// cluster kernels', with rounds of equal width (codec_cuda.db_geometry),
// `tc` dividing the chunk count, 1..kMaxSlots slots (a power of two), and
// a walk whose items (a chunk's rounds, twice past the register budget,
// times `rows` rows) a 32-bit index counts.
bool db_cluster_ok(long long chunks, int tc, int B, int k, int threads, int slots, int rows) {
  const long long rounds = (B / k) / threads;
  return db_geometry_ok(chunks, tc, B) && cluster_geometry_ok(chunks, B, k, threads) &&
         (B / k) % threads == 0 &&
         slots >= 1 && slots <= kMaxSlots && (slots & (slots - 1)) == 0 && rows >= 1 &&
         chunks * 2 * rounds * rows + kMaxSlots <= 0x7fffffffLL;
}

// One launch of B4 at row count ROWS (0: any) and width VEC, the raw own
// row (if any) of element type E; the 16-bit instances exist with the raw
// row alone (without one the wire dtype plays no part).
template <int BITS, int ROWS, int VEC, typename E, int ACCUM = kAccumExact>
void reduce_rows_start(const int32_t* words, const float* meta, const E* raw, int own, int ws,
                       long long chunks, int B, float* out, long long blocks, int wire,
                       cudaStream_t st) {
  if (raw != nullptr) {
    cgx_reduce_rows_kernel<BITS, ROWS, VEC, true, E, ACCUM>
        <<<(unsigned)blocks, kReduceThreads, 0, st>>>(words, meta, raw, own, ws, chunks, B, out,
                                                      wire);
  } else if constexpr (sizeof(E) == 4) {
    cgx_reduce_rows_kernel<BITS, ROWS, VEC, false, E, ACCUM>
        <<<(unsigned)blocks, kReduceThreads, 0, st>>>(words, meta, raw, own, ws, chunks, B, out,
                                                      wire);
  }
}

bool aligned_to(const void* p, size_t bytes) { return ((uintptr_t)p % bytes) == 0; }

// An entry body's instance for the launch's rounding and wire dtype:
// f(Flag<STOCH>{}, (const E*)nullptr) with E float for kWireF32 and
// uint16_t for the 16-bit dtypes; another wire code is refused.
template <bool V>
struct Flag {
  static constexpr bool value = V;
};
template <typename F>
int by_instance(int stochastic, int wire, const F& f) {
  if (wire == kWireF32) {
    return stochastic ? f(Flag<true>{}, (const float*)nullptr) : f(Flag<false>{}, (const float*)nullptr);
  }
  if (wire != kWireBf16 && wire != kWireF16) return (int)cudaErrorInvalidValue;
  return stochastic ? f(Flag<true>{}, (const uint16_t*)nullptr)
                    : f(Flag<false>{}, (const uint16_t*)nullptr);
}

}  // namespace


// The build compiles this file once per part (-DCGX_PART=0..22), the parts
// in parallel, and links them into one library; without CGX_PART it
// compiles every entry point. Parts 7-10 hold the stochastic f32
// instances, parts 11-18 the 16-bit ones (of B1, B3, B7a, B7c, each round
// to nearest and stochastic), part 19 B4's with a 16-bit raw row, part 20
// B8's 16-bit operands on the FFMA kernel, part 21 the tensor-core kernel
// (bf16 and f16) and its entry point, part 22 B8's float32 operands on the
// tensor cores (the split pass, the split-TF32 kernel and their entry
// points). With -DCGX_INT8 it compiles the int8 fold's library instead
// (parts 0-9).
#ifdef CGX_PART
#define CGX_IN_PART(k) (CGX_PART == (k))
#else
#define CGX_IN_PART(k) 1
#endif

namespace cgx {

// The bodies of the entry points of B1, B3, B7a, B7c and B4 for each
// instance: B1, B3, B7a, B7c by stochastic rounding (STOCH) and element
// type E, B4 by E. The f32 round-to-nearest ones build with their entry
// point (parts 0, 2, 4, 5, 6), the others in parts of their own.
template <bool STOCH, typename E>
int quantize_entry(const E* x, int32_t* words, float* meta, long long chunks, int B, int bits,
                   float inv, int encode, int pack, int k, int threads, uint2 seed, int wire,
                   void* stream) {
  if (chunks < 1 || B < 32 || B % 32 || !cluster_geometry_ok(chunks, B, k, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const bool reread = B / k > threads;
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    cudaError_t e = reread
        ? cluster_launch(cgx_quantize_cluster_kernel<BITS, ENCODE, PACK, true, STOCH, E>, chunks,
                         k, threads, stage_bytes(PACK, threads), st, x, words, meta, B, k, inv,
                         seed, wire)
        : cluster_launch(cgx_quantize_cluster_kernel<BITS, ENCODE, PACK, false, STOCH, E>, chunks,
                         k, threads, stage_bytes(PACK, threads), st, x, words, meta, B, k, inv,
                         seed, wire);
    if (e != cudaSuccess) return (int)e;
  }));
  return (int)cudaGetLastError();
}

// One launch of B9's VARIANT body on a checked cluster geometry.
template <int VARIANT>
int quantize_variant_entry(const float* x, int32_t* words, float* meta, long long chunks, int B,
                           int bits, float inv, int k, int threads, cudaStream_t st) {
  const bool reread = B / k > threads;
  CGX_DISPATCH_BITS(bits, {
    cudaError_t e = reread
        ? cluster_launch(cgx_quantize_variant_cluster_kernel<BITS, VARIANT, true>, chunks, k,
                         threads, 0, st, x, words, meta, B, k, inv)
        : cluster_launch(cgx_quantize_variant_cluster_kernel<BITS, VARIANT, false>, chunks, k,
                         threads, 0, st, x, words, meta, B, k, inv);
    if (e != cudaSuccess) return (int)e;
  });
  return (int)cudaGetLastError();
}

template <bool STOCH, typename E, int ACCUM = kAccumExact>
int sra_epilogue_entry(const int32_t* words, const float* meta, const E* raw, int own, int ws,
                       long long chunks, int B, int bits, float inv, int encode, int pack, int k,
                       int threads, uint2 seed, int32_t* out_words, float* out_meta, int wire,
                       void* stream) {
  if (chunks < 1 || ws < 1 || own >= ws || B < 32 || B % 32) return (int)cudaErrorInvalidValue;
  if ((raw == nullptr) != (own < 0)) return (int)cudaErrorInvalidValue;
  if (!cluster_geometry_ok(chunks, B, k, threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t meta_bytes = (size_t)ws * 2 * kChunkBuckets * sizeof(float) +
                            (ACCUM == kAccumInt8 ? int8_smem_bytes(ws) : 0);
  const bool reread = B / k > threads;
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    const size_t smem = meta_bytes + stage_bytes(PACK, threads);
    cudaError_t e = reread
        ? cluster_launch(cgx_sra_epilogue_cluster_kernel<BITS, ENCODE, PACK, true, STOCH, E, ACCUM>,
                         chunks, k, threads, smem, st, words, meta, raw, own, ws, chunks, B, k, inv,
                         out_words, out_meta, seed, wire)
        : cluster_launch(cgx_sra_epilogue_cluster_kernel<BITS, ENCODE, PACK, false, STOCH, E, ACCUM>,
                         chunks, k, threads, smem, st, words, meta, raw, own, ws, chunks, B, k, inv,
                         out_words, out_meta, seed, wire);
    if (e != cudaSuccess) return (int)e;
  }));
  return (int)cudaGetLastError();
}

template <bool STOCH, typename E>
int quantize_db_entry(const E* x, int32_t* words, float* meta, long long chunks, int tc, int B,
                      int bits, float inv, int encode, int pack, int k, int threads, int slots,
                      uint2 seed, int wire, void* stream) {
  if (!db_cluster_ok(chunks, tc, B, k, threads, slots, 1) || !aligned16(x)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (int)(chunks / tc);
  const bool reread = B / k > threads;
  const size_t ring = kBarBytes + (size_t)slots * kChunkBuckets * threads * sizeof(E);
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    const size_t smem = ring + stage_bytes(PACK, threads);
    cudaError_t e =
        reread ? persistent_cluster_launch(
                     cgx_quantize_db_cluster_kernel<BITS, ENCODE, PACK, true, STOCH, E>, tiles, k,
                     threads, smem, st, x, words, meta, tiles, tc, B, k, inv, slots, seed, wire)
               : persistent_cluster_launch(
                     cgx_quantize_db_cluster_kernel<BITS, ENCODE, PACK, false, STOCH, E>, tiles, k,
                     threads, smem, st, x, words, meta, tiles, tc, B, k, inv, slots, seed, wire);
    if (e != cudaSuccess) return (int)e;
  }));
  return (int)cudaGetLastError();
}

template <bool STOCH, typename E, int ACCUM = kAccumExact>
int sra_epilogue_db_entry(const int32_t* words, const float* meta, const E* raw, int own,
                          int ws, long long chunks, int tc, int B, int bits, float inv, int encode,
                          int pack, int k, int threads, int slots, uint2 seed, int32_t* out_words,
                          float* out_meta, int wire, void* stream) {
  if (!db_cluster_ok(chunks, tc, B, k, threads, slots, ws) || own >= ws) {
    return (int)cudaErrorInvalidValue;
  }
  if ((raw == nullptr) != (own < 0)) return (int)cudaErrorInvalidValue;
  if (!aligned16(words) || !aligned16(meta) || (raw && !aligned16(raw))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (int)(chunks / tc), n = (int)chunks;
  const bool reread = B / k > threads;
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    const size_t smem = kBarBytes +
                        (size_t)slots * ((size_t)BITS * threads + 2 * kChunkBuckets) * 4 +
                        stage_bytes(PACK, threads) +
                        (ACCUM == kAccumInt8 ? int8_smem_bytes(ws) : 0);
    cudaError_t e =
        reread ? persistent_cluster_launch(
                     cgx_sra_epilogue_db_cluster_kernel<BITS, ENCODE, PACK, true, STOCH, E, ACCUM>,
                     tiles, k, threads, smem, st, words, meta, raw, own, ws, n, tiles, tc, B, k,
                     inv, slots, out_words, out_meta, seed, wire)
               : persistent_cluster_launch(
                     cgx_sra_epilogue_db_cluster_kernel<BITS, ENCODE, PACK, false, STOCH, E, ACCUM>,
                     tiles, k, threads, smem, st, words, meta, raw, own, ws, n, tiles, tc, B, k,
                     inv, slots, out_words, out_meta, seed, wire);
    if (e != cudaSuccess) return (int)e;
  }));
  return (int)cudaGetLastError();
}

template <typename E, int ACCUM = kAccumExact>
int reduce_rows_entry(const int32_t* words, const float* meta, const E* raw, int own, int ws,
                      long long chunks, int B, int bits, int vec, float* out, int wire,
                      void* stream) {
  if (vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
  if (chunks < 1 || ws < 1 || B < 32 || B % (kReduceVectors * vec)) return (int)cudaErrorInvalidValue;
  if ((raw == nullptr) != (own < 0) || own >= ws) return (int)cudaErrorInvalidValue;
  // Full width: four values a load, so a raw row aligned to four of them.
  if (vec == 4 && (!aligned16(words) || !aligned16(meta) || !aligned16(out) ||
                   (raw != nullptr && !aligned_to(raw, 4 * sizeof(E))))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = chunks * (B / (kReduceVectors * vec));
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec == 1) {
    CGX_DISPATCH_BITS(bits, reduce_rows_start<BITS, 0, 1, E, ACCUM>(words, meta, raw, own, ws,
                                                                    chunks, B, out, blocks, wire,
                                                                    st));
  } else if constexpr (ACCUM == kAccumInt8) {
    // The int8 fold takes one integer multiply-add a row: the any-count
    // instance serves every row count.
    CGX_DISPATCH_BITS(bits, reduce_rows_start<BITS, 0, 4, E, ACCUM>(words, meta, raw, own, ws,
                                                                    chunks, B, out, blocks, wire,
                                                                    st));
  } else {
    CGX_DISPATCH_BITS(bits, CGX_DISPATCH_ROWS(ws, reduce_rows_start<BITS, ROWS, 4, E>(
        words, meta, raw, own, ws, chunks, B, out, blocks, wire, st)));
  }
  return (int)cudaGetLastError();
}

// B8's body for element type E (float, or uint16_t for both 16-bit wire
// dtypes, whose format is `wire`): one cooperative launch of the
// persistent grid.
template <typename E>
int matmul_quantize_entry(const E* x2, const E* g2, long long k_total, int din, int o, float div,
                          float* work, int* arrivals, float* raw, long long raw_lo,
                          long long raw_n, int32_t* words, float* meta, int B, int bits,
                          float inv, int encode, int pack, int wire, void* stream) {
  constexpr int V = 16 / (int)sizeof(E);  // values a 16-byte copy moves
  const long long n = (long long)din * o;
  const long long chunk_n = (long long)kChunkBuckets * B;
  if (k_total < 1 || din < 1 || o < 4 || o % 4 || B < 32 || B % 32 || n % chunk_n ||
      (sizeof(E) == 4 && !aligned16(g2)) || !aligned16(work) || arrivals == nullptr ||
      raw_lo < 0 || raw_n < 0 || raw_lo % 4 || raw_n % 4 || raw_lo + raw_n > n ||
      (raw_n > 0 && (raw == nullptr || !aligned16(raw)))) {
    return (int)cudaErrorInvalidValue;
  }
  int x_vec = din % V == 0 && aligned16(x2);
  int g_vec = o % V == 0 && aligned16(g2);
  int tiles_n = (o + kMmBN - 1) / kMmBN;
  long long tiles = (long long)((din + kMmBM - 1) / kMmBM) * tiles_n;
  cudaStream_t st = (cudaStream_t)stream;
  // The ring, or a whole chunk while the block quantizes it.
  const size_t ring = (size_t)kMmStages * kMmStageElems * sizeof(E);
  const size_t tile = (size_t)chunk_n * sizeof(float);
  const size_t smem = ring > tile ? ring : tile;
  void* args[] = {&x2, &g2, &k_total, &din, &o, &tiles_n, &tiles, &div, &B, &inv, &x_vec,
                  &work, &arrivals, &raw, &raw_lo, &raw_n, &words, &meta, &g_vec, &wire};
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    auto kernel = cgx_matmul_quantize_kernel<BITS, ENCODE, PACK, E>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmThreads, smem);
    }
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long most = (long long)per_sm * sms;
    const long long want = tiles > n / chunk_n ? tiles : n / chunk_n;
    const unsigned grid = (unsigned)(want < most ? want : most);
    e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kMmThreads), args, smem,
                                    st);
    if (e != cudaSuccess) return (int)e;
  }));
  return (int)cudaGetLastError();
}

#if CGX_IN_PART(21) || CGX_IN_PART(22)
// cuTensorMapEncodeTiled from the driver the runtime loaded, so that the
// library links no libcuda; null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// The arguments of B8's tensor-core bodies beside the two maps, and the
// checks they share: dw (din, o) in whole 32-bucket chunks, the
// workspace, counters and raw row as cgx_matmul_quantize's.
static bool tc_args_ok(long long k_total, int din, int o, int B, float* work, int* arrivals,
                       float* raw, long long raw_lo, long long raw_n) {
  const long long n = (long long)din * o;
  const long long chunk_n = (long long)kChunkBuckets * B;
  return k_total >= 1 && k_total <= 0x7fffffffLL && din >= 1 && o >= 4 && o % 4 == 0 && B >= 32 &&
         B % 32 == 0 && n % chunk_n == 0 && aligned16(work) && arrivals != nullptr && raw_lo >= 0 &&
         raw_n >= 0 && raw_lo % 4 == 0 && raw_n % 4 == 0 && raw_lo + raw_n <= n &&
         (raw_n == 0 || (raw != nullptr && aligned16(raw)));
}

// One cooperative launch of a tensor-core body's persistent grid (at most
// one block an SM, as many as the tiles or the chunks ask) with the ring
// (`ring` bytes) or a whole chunk in dynamic shared memory.
template <typename K>
static int tc_launch(K kernel, const CUtensorMap& x_map, const CUtensorMap& g_map,
                     long long k_total, int din, int o, float div, float* work, int* arrivals,
                     float* raw, long long raw_lo, long long raw_n, int32_t* words, float* meta,
                     int B, float inv, size_t ring, void* stream) {
  const long long n = (long long)din * o;
  const long long chunk_n = (long long)kChunkBuckets * B;
  int tiles_n = (o + kTcBN - 1) / kTcBN;
  long long tiles = (long long)((din + kTcBM - 1) / kTcBM) * tiles_n;
  const size_t tile = (size_t)chunk_n * sizeof(float);
  const size_t smem = (ring > tile ? ring : tile) + kTcSwizzleBytes;  // and the ring's alignment
  // 1/div where div is a power of two whose reciprocal is a normal float.
  uint32_t div_bits;
  memcpy(&div_bits, &div, sizeof div_bits);
  const uint32_t div_exp = (div_bits >> 23) & 0xff;
  float rdiv = (div_bits & 0x807fffffu) == 0 && div_exp >= 1 && div_exp <= 253 ? 1.f / div : 0.f;
  CUtensorMap xm = x_map, gm = g_map;
  void* args[] = {&xm, &gm, &k_total, &din, &o, &tiles_n, &tiles, &div, &rdiv, &B,
                  &inv, &work, &arrivals, &raw, &raw_lo, &raw_n, &words, &meta};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long most = (long long)per_sm * sms;
  const long long want = tiles > n / chunk_n ? tiles : n / chunk_n;
  const unsigned grid = (unsigned)(want < most ? want : most);
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kTcThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) (void)cudaGetLastError();
  return (int)err;
}
#endif

#if CGX_IN_PART(21)
// The TMA map of a row-major (rows, cols) operand of 16-bit values in
// boxes of kTcBox columns x kTcBK rows, 128-byte swizzled, zero-filled
// past its edges.
cudaError_t tc_map(CUtensorMap* map, const uint16_t* base, long long rows, int cols, int wire) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {kTcBox, kTcBK};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, wire == kWireF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<uint16_t*>(base), dim, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// B8's tensor-core body (bf16 or f16 operands, `wire`): the operands' TMA
// maps, then one cooperative launch of the persistent grid. Takes what
// codec_cuda.mm_tc_eligible admits: din and o multiples of 8, both
// operands 16-byte aligned.
int matmul_quantize_tc_entry(const uint16_t* x2, const uint16_t* g2, long long k_total, int din,
                             int o, float div, float* work, int* arrivals, float* raw,
                             long long raw_lo, long long raw_n, int32_t* words, float* meta, int B,
                             int bits, float inv, int encode, int pack, int wire, void* stream) {
  if (!tc_args_ok(k_total, din, o, B, work, arrivals, raw, raw_lo, raw_n) || din % 8 || o % 8 ||
      !aligned16(x2) || !aligned16(g2) || (wire != kWireBf16 && wire != kWireF16)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap x_map, g_map;
  cudaError_t e = tc_map(&x_map, x2, k_total, din, wire);
  if (e == cudaSuccess) e = tc_map(&g_map, g2, k_total, o, wire);
  if (e != cudaSuccess) return (int)e;
  const size_t ring = (size_t)kTcStages * kTcStageBytes;
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    const int err = wire == kWireF16
        ? tc_launch(cgx_matmul_quantize_tc_kernel<BITS, ENCODE, PACK, kWireF16, uint16_t>, x_map,
                    g_map, k_total, din, o, div, work, arrivals, raw, raw_lo, raw_n, words, meta,
                    B, inv, ring, stream)
        : tc_launch(cgx_matmul_quantize_tc_kernel<BITS, ENCODE, PACK, kWireBf16, uint16_t>, x_map,
                    g_map, k_total, din, o, div, work, arrivals, raw, raw_lo, raw_n, words, meta,
                    B, inv, ring, stream);
    if (err != cudaSuccess) return err;
  }));
  return (int)cudaGetLastError();
}
#endif

#if CGX_IN_PART(22)
// The 3-D TMA map of the split pass's planes (2, rows, kp) of f32 values in
// boxes of kTf32BK contraction steps x box_rows rows x one plane, 128-byte
// swizzled (a box row is the swizzle's 128 bytes), zero-filled past the
// rows.
static cudaError_t tf32_map(CUtensorMap* map, const float* planes, int rows, long long kp,
                            int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dim[3] = {(cuuint64_t)kp, (cuuint64_t)rows, 2};
  const cuuint64_t stride[2] = {(cuuint64_t)kp * 4, (cuuint64_t)rows * kp * 4};
  const cuuint32_t box[3] = {kTf32BK, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(planes),
                            dim, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// B8's float32 body on the split pass's planes xs (2, din, kp) and gs (2,
// o, kp): their TMA maps, then one cooperative launch. kp a multiple of
// kTf32BK; any din, o % 4 == 0 (the FFMA kernel's condition).
int matmul_quantize_tf32_entry(const float* xs, const float* gs, long long kp, int din, int o,
                               float div, float* work, int* arrivals, float* raw,
                               long long raw_lo, long long raw_n, int32_t* words, float* meta,
                               int B, int bits, float inv, int encode, int pack, void* stream) {
  if (!tc_args_ok(kp, din, o, B, work, arrivals, raw, raw_lo, raw_n) || kp % kTf32BK ||
      !aligned16(xs) || !aligned16(gs)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap x_map, g_map;
  cudaError_t e = tf32_map(&x_map, xs, din, kp, kTcBM);
  if (e == cudaSuccess) e = tf32_map(&g_map, gs, o, kp, kTcBN);
  if (e != cudaSuccess) return (int)e;
  const size_t ring = (size_t)kTf32Stages * kTf32StageBytes;
  CGX_DISPATCH_BITS(bits, CGX_DISPATCH_LOWERING(encode, pack, {
    const int err = tc_launch(cgx_matmul_quantize_tf32_kernel<BITS, ENCODE, PACK>, x_map, g_map, kp,
                              din, o, div, work, arrivals, raw, raw_lo, raw_n, words, meta, B, inv,
                              ring, stream);
    if (err != cudaSuccess) return err;
  }));
  return (int)cudaGetLastError();
}

// The split pass of both operands, one launch.
int tf32_split_entry(const float* x2, const float* g2, long long k_total, int din, int o,
                     long long kp, float* xs, float* gs, void* stream) {
  if (k_total < 1 || din < 1 || o < 1 || kp < k_total || kp % kTf32BK || kp > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int x_tiles = (din + kSplitCols - 1) / kSplitCols;
  const long long cols = (long long)x_tiles + (o + kSplitCols - 1) / kSplitCols;
  const long long ky = kp / kSplitTile;
  if (cols > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int x_vec = din % 4 == 0 && aligned16(x2), g_vec = o % 4 == 0 && aligned16(g2);
  const dim3 grid((unsigned)cols, (unsigned)(ky < 65535 ? ky : 65535));
  cgx_tf32_split_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(x2, g2, k_total, din, o, kp,
                                                                  x_tiles, x_vec, g_vec, xs, gs);
  return (int)cudaGetLastError();
}
#endif

#ifndef CGX_INT8
// Each instance but an entry point's f32 round-to-nearest one is compiled
// in its part alone; the other parts only declare it.
#define CGX_QUANTIZE_ENTRY(S, E)                                                                \
  int quantize_entry<S, E>(const E*, int32_t*, float*, long long, int, int, float, int, int,  \
                           int, int, uint2, int, void*)
#define CGX_EPILOGUE_ENTRY(S, E)                                                                \
  int sra_epilogue_entry<S, E>(const int32_t*, const float*, const E*, int, int, long long, int, \
                               int, float, int, int, int, int, uint2, int32_t*, float*, int,     \
                               void*)
#define CGX_QUANTIZE_DB_ENTRY(S, E)                                                             \
  int quantize_db_entry<S, E>(const E*, int32_t*, float*, long long, int, int, int, float, int, \
                              int, int, int, int, uint2, int, void*)
#define CGX_EPILOGUE_DB_ENTRY(S, E)                                                             \
  int sra_epilogue_db_entry<S, E>(const int32_t*, const float*, const E*, int, int, long long,  \
                                  int, int, int, float, int, int, int, int, int, uint2, int32_t*, \
                                  float*, int, void*)

#if CGX_IN_PART(7)
template CGX_QUANTIZE_ENTRY(true, float);
#else
extern template CGX_QUANTIZE_ENTRY(true, float);
#endif
#if CGX_IN_PART(8)
template CGX_EPILOGUE_ENTRY(true, float);
#else
extern template CGX_EPILOGUE_ENTRY(true, float);
#endif
#if CGX_IN_PART(9)
template CGX_QUANTIZE_DB_ENTRY(true, float);
#else
extern template CGX_QUANTIZE_DB_ENTRY(true, float);
#endif
#if CGX_IN_PART(10)
template CGX_EPILOGUE_DB_ENTRY(true, float);
#else
extern template CGX_EPILOGUE_DB_ENTRY(true, float);
#endif
#if CGX_IN_PART(11)
template CGX_QUANTIZE_ENTRY(false, uint16_t);
#else
extern template CGX_QUANTIZE_ENTRY(false, uint16_t);
#endif
#if CGX_IN_PART(12)
template CGX_QUANTIZE_ENTRY(true, uint16_t);
#else
extern template CGX_QUANTIZE_ENTRY(true, uint16_t);
#endif
#if CGX_IN_PART(13)
template CGX_EPILOGUE_ENTRY(false, uint16_t);
#else
extern template CGX_EPILOGUE_ENTRY(false, uint16_t);
#endif
#if CGX_IN_PART(14)
template CGX_EPILOGUE_ENTRY(true, uint16_t);
#else
extern template CGX_EPILOGUE_ENTRY(true, uint16_t);
#endif
#if CGX_IN_PART(15)
template CGX_QUANTIZE_DB_ENTRY(false, uint16_t);
#else
extern template CGX_QUANTIZE_DB_ENTRY(false, uint16_t);
#endif
#if CGX_IN_PART(16)
template CGX_QUANTIZE_DB_ENTRY(true, uint16_t);
#else
extern template CGX_QUANTIZE_DB_ENTRY(true, uint16_t);
#endif
#if CGX_IN_PART(17)
template CGX_EPILOGUE_DB_ENTRY(false, uint16_t);
#else
extern template CGX_EPILOGUE_DB_ENTRY(false, uint16_t);
#endif
#if CGX_IN_PART(18)
template CGX_EPILOGUE_DB_ENTRY(true, uint16_t);
#else
extern template CGX_EPILOGUE_DB_ENTRY(true, uint16_t);
#endif
#if CGX_IN_PART(19)
template int reduce_rows_entry<uint16_t>(const int32_t*, const float*, const uint16_t*, int, int,
                                         long long, int, int, int, float*, int, void*);
#else
extern template int reduce_rows_entry<uint16_t>(const int32_t*, const float*, const uint16_t*, int,
                                                int, long long, int, int, int, float*, int, void*);
#endif
#if CGX_IN_PART(20)
template int matmul_quantize_entry<uint16_t>(const uint16_t*, const uint16_t*, long long, int, int,
                                             float, float*, int*, float*, long long, long long,
                                             int32_t*, float*, int, int, float, int, int, int,
                                             void*);
#else
extern template int matmul_quantize_entry<uint16_t>(const uint16_t*, const uint16_t*, long long,
                                                    int, int, float, float*, int*, float*,
                                                    long long, long long, int32_t*, float*, int,
                                                    int, float, int, int, int, void*);
#endif
#else  // CGX_INT8
// The int8 library (-DCGX_INT8, codec_cuda.build_int8): the int8 fold's
// instances of B3, B7c and B4 and their entry points alone, in parts of
// their own (-DCGX_PART=0..9, CGX_IN_INT8_PART): part 0 the entry points
// and B4 with an f32 raw row or none, parts 1-4 B3, 5-8 B7c (f32 round to
// nearest, f32 stochastic, 16-bit round to nearest, 16-bit stochastic),
// part 9 B4 with a 16-bit raw row. The default build leaves them out.
#define CGX_IN_INT8_PART(k) CGX_IN_PART(k)
#define CGX_EPILOGUE_INT8_ENTRY(S, E)                                                           \
  int sra_epilogue_entry<S, E, kAccumInt8>(const int32_t*, const float*, const E*, int, int,    \
                                           long long, int, int, float, int, int, int, int, uint2, \
                                           int32_t*, float*, int, void*)
#define CGX_EPILOGUE_DB_INT8_ENTRY(S, E)                                                        \
  int sra_epilogue_db_entry<S, E, kAccumInt8>(const int32_t*, const float*, const E*, int, int, \
                                              long long, int, int, int, float, int, int, int,   \
                                              int, int, uint2, int32_t*, float*, int, void*)

#if CGX_IN_INT8_PART(1)
template CGX_EPILOGUE_INT8_ENTRY(false, float);
#else
extern template CGX_EPILOGUE_INT8_ENTRY(false, float);
#endif
#if CGX_IN_INT8_PART(2)
template CGX_EPILOGUE_INT8_ENTRY(true, float);
#else
extern template CGX_EPILOGUE_INT8_ENTRY(true, float);
#endif
#if CGX_IN_INT8_PART(3)
template CGX_EPILOGUE_INT8_ENTRY(false, uint16_t);
#else
extern template CGX_EPILOGUE_INT8_ENTRY(false, uint16_t);
#endif
#if CGX_IN_INT8_PART(4)
template CGX_EPILOGUE_INT8_ENTRY(true, uint16_t);
#else
extern template CGX_EPILOGUE_INT8_ENTRY(true, uint16_t);
#endif
#if CGX_IN_INT8_PART(5)
template CGX_EPILOGUE_DB_INT8_ENTRY(false, float);
#else
extern template CGX_EPILOGUE_DB_INT8_ENTRY(false, float);
#endif
#if CGX_IN_INT8_PART(6)
template CGX_EPILOGUE_DB_INT8_ENTRY(true, float);
#else
extern template CGX_EPILOGUE_DB_INT8_ENTRY(true, float);
#endif
#if CGX_IN_INT8_PART(7)
template CGX_EPILOGUE_DB_INT8_ENTRY(false, uint16_t);
#else
extern template CGX_EPILOGUE_DB_INT8_ENTRY(false, uint16_t);
#endif
#if CGX_IN_INT8_PART(8)
template CGX_EPILOGUE_DB_INT8_ENTRY(true, uint16_t);
#else
extern template CGX_EPILOGUE_DB_INT8_ENTRY(true, uint16_t);
#endif
#if CGX_IN_INT8_PART(9)
template int reduce_rows_entry<uint16_t, kAccumInt8>(const int32_t*, const float*, const uint16_t*,
                                                     int, int, long long, int, int, int, float*, int,
                                                     void*);
#else
extern template int reduce_rows_entry<uint16_t, kAccumInt8>(const int32_t*, const float*,
                                                            const uint16_t*, int, int, long long,
                                                            int, int, int, float*, int, void*);
#endif
#endif  // CGX_INT8

}  // namespace cgx

extern "C" {

#ifndef CGX_INT8
// Every quantizing entry point takes `encode` (0 div, 1 mul), `pack` (0
// sum, 1 butterfly) and `stochastic` (0: round to nearest; else round
// stochastically under the seed (k0, k1)). B1, B3, B7a, B7c and B4 take
// `wire`, the wire dtype (kWireF32, kWireBf16, kWireF16: codec_cuda.
// WIRE_DTYPES) of B1's and B7a's input, of the raw own row of B3, B7c and
// B4, and the dtype B3 and B7c round the folded values through; the
// other operands and the outputs are f32 (words int32).

#if CGX_IN_PART(0)
// x: chunks*32*B values of the wire dtype -> words: chunks*bits*B int32,
// meta: chunks*32*2 f32. The cluster geometry (codec_cuda.cluster_geometry):
// clusters of k CTAs of `threads` threads, each thread B/(k*threads)
// positions (rounded up).
int cgx_quantize(const void* x, int32_t* words, float* meta, long long chunks,
                 int B, int bits, float inv, int encode, int pack, int k, int threads,
                 int stochastic, unsigned k0, unsigned k1, int wire, void* stream) {
  const uint2 seed = make_uint2(k0, k1);
  return by_instance(stochastic, wire, [&](auto st, auto e) {
    using E = std::remove_const_t<std::remove_pointer_t<decltype(e)>>;
    return cgx::quantize_entry<decltype(st)::value, E>(static_cast<const E*>(x), words, meta,
                                                       chunks, B, bits, inv, encode, pack, k,
                                                       threads, seed, wire, stream);
  });
}
#endif

#if CGX_IN_PART(0)
// The CUDA runtime's name of an error code the entry points return.
const char* cgx_error_name(int err) { return cudaGetErrorName((cudaError_t)err); }
#endif

#if CGX_IN_PART(0)
// The reciprocal quotient against the IEEE divide (cgx_div_sweep_kernel):
// counts (4 uint64) and first (2 f32) zeroed by the caller.
int cgx_div_sweep(int e2, int m0, int m_step, int ulps, int extra, unsigned long long* counts,
                  float* first, void* stream) {
  if (m0 < 0 || m_step < 1 || ulps < 0 || extra < 0 || e2 < -126 || e2 > 127) {
    return (int)cudaErrorInvalidValue;
  }
  cgx_div_sweep_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(e2, m0, m_step, ulps, extra, counts,
                                                               first);
  return (int)cudaGetLastError();
}

int cgx_div_pairs(const float* a, const float* d, int n, float* q_fast, float* q_ref,
                  void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cgx_div_pairs_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, d, n, q_fast, q_ref);
  return (int)cudaGetLastError();
}
#endif

#if CGX_IN_PART(1)
// B9's bodies on B1's cluster geometry (k, threads as cgx_quantize's). x:
// chunks*32*B f32 -> words: chunks*bits*B int32; meta: chunks*32*2 f32
// (variant 0 nometa, 2 read) or chunks*128 f32 (1 metalane).
int cgx_quantize_variant(const float* x, int32_t* words, float* meta, long long chunks,
                         int B, int bits, int variant, float inv, int k, int threads,
                         void* stream) {
  if (chunks < 1 || B < 32 || B % 32 || !cluster_geometry_ok(chunks, B, k, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case kVariantNoMeta:
      return cgx::quantize_variant_entry<kVariantNoMeta>(x, words, meta, chunks, B, bits, inv, k,
                                                         threads, st);
    case kVariantMetaLane:
      return cgx::quantize_variant_entry<kVariantMetaLane>(x, words, meta, chunks, B, bits, inv, k,
                                                           threads, st);
    case kVariantRead:
      return cgx::quantize_variant_entry<kVariantRead>(x, words, meta, chunks, B, bits, inv, k,
                                                       threads, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
// raw: the own row's chunks*32*B values of the wire dtype (null with own
// == -1) -> the requantized reduced chunk, rounded through the wire dtype:
// out_words chunks*bits*B, out_meta chunks*32*2. The cluster geometry as
// cgx_quantize's.
int cgx_sra_epilogue(const int32_t* words, const float* meta, const void* raw,
                     int own, int ws, long long chunks, int B, int bits,
                     float inv, int encode, int pack, int k, int threads, int stochastic,
                     unsigned k0, unsigned k1, int32_t* out_words, float* out_meta, int wire,
                     void* stream) {
  const uint2 seed = make_uint2(k0, k1);
  return by_instance(stochastic, wire, [&](auto st, auto e) {
    using E = std::remove_const_t<std::remove_pointer_t<decltype(e)>>;
    return cgx::sra_epilogue_entry<decltype(st)::value, E>(
        words, meta, static_cast<const E*>(raw), own, ws, chunks, B, bits, inv, encode, pack, k,
        threads, seed, out_words, out_meta, wire, stream);
  });
}
#endif


#if CGX_IN_PART(3)
// x2: k_total*din, g2: k_total*o values of the wire dtype (row-major; f32:
// g2 16-byte aligned) -> the flat dw = x2^T g2 / div quantized: words
// (din*o/(32*B))*bits*B int32, meta (din*o/B)*2 f32, and raw: the f32 dw /
// div at flat [raw_lo, raw_lo + raw_n), for 16-bit operands each sum
// rounded to the wire dtype before the divide (raw_n 0 and raw null: none;
// both multiples of 4, raw 16-byte aligned). din*o must be whole 32-bucket
// chunks, o % 4 == 0. work: din*o f32 of scratch (16-byte aligned);
// arrivals: one int32 a chunk, zero before the launch.
int cgx_matmul_quantize(const void* x2, const void* g2, long long k_total, int din, int o,
                        float div, float* work, int* arrivals, float* raw, long long raw_lo,
                        long long raw_n, int32_t* words, float* meta, int B, int bits, float inv,
                        int encode, int pack, int wire, void* stream) {
  if (wire == kWireF32) {
    return cgx::matmul_quantize_entry<float>(static_cast<const float*>(x2),
                                             static_cast<const float*>(g2), k_total, din, o, div,
                                             work, arrivals, raw, raw_lo, raw_n, words, meta, B,
                                             bits, inv, encode, pack, wire, stream);
  }
  if (wire != kWireBf16 && wire != kWireF16) return (int)cudaErrorInvalidValue;
  return cgx::matmul_quantize_entry<uint16_t>(static_cast<const uint16_t*>(x2),
                                              static_cast<const uint16_t*>(g2), k_total, din, o,
                                              div, work, arrivals, raw, raw_lo, raw_n, words, meta,
                                              B, bits, inv, encode, pack, wire, stream);
}
#endif

#if CGX_IN_PART(21)
// cgx_matmul_quantize on tensor cores: the same arguments, x2 and g2 bf16
// or f16 (`wire`), din and o multiples of 8, x2 and g2 16-byte aligned.
int cgx_matmul_quantize_tc(const void* x2, const void* g2, long long k_total, int din, int o,
                           float div, float* work, int* arrivals, float* raw, long long raw_lo,
                           long long raw_n, int32_t* words, float* meta, int B, int bits,
                           float inv, int encode, int pack, int wire, void* stream) {
  return cgx::matmul_quantize_tc_entry(static_cast<const uint16_t*>(x2),
                                       static_cast<const uint16_t*>(g2), k_total, din, o, div,
                                       work, arrivals, raw, raw_lo, raw_n, words, meta, B, bits,
                                       inv, encode, pack, wire, stream);
}
#endif

#if CGX_IN_PART(22)
// B8's float32 operands as split TF32: the split pass, x2 (k_total, din)
// and g2 (k_total, o) f32 row-major -> xs (2, din, kp) and gs (2, o, kp),
// the hi and lo planes of their transposes, K padded with zeros to kp (a
// multiple of 32; all four 16-byte aligned).
int cgx_tf32_split(const float* x2, const float* g2, long long k_total, int din, int o,
                   long long kp, float* xs, float* gs, void* stream) {
  return cgx::tf32_split_entry(x2, g2, k_total, din, o, kp, xs, gs, stream);
}

// Then the product on the tensor cores: cgx_matmul_quantize's arguments
// with the planes in place of x2 and g2 and kp in place of k_total; any
// din, o % 4 == 0; `wire` must be 0 (float32).
int cgx_matmul_quantize_tf32(const void* xs, const void* gs, long long kp, int din, int o,
                             float div, float* work, int* arrivals, float* raw, long long raw_lo,
                             long long raw_n, int32_t* words, float* meta, int B, int bits,
                             float inv, int encode, int pack, int wire, void* stream) {
  if (wire != kWireF32) return (int)cudaErrorInvalidValue;
  return cgx::matmul_quantize_tf32_entry(static_cast<const float*>(xs),
                                         static_cast<const float*>(gs), kp, din, o, div, work,
                                         arrivals, raw, raw_lo, raw_n, words, meta, B, bits, inv,
                                         encode, pack, stream);
}
#endif

// The pipelined kernels take the arguments of their single-stage siblings
// and `tc`, the chunks a tile holds, which divides the chunk count; every
// pointer is 16-byte aligned. B7b's slots hold a tile: tc*(bits*B*4 + 256)
// bytes (+ tc*32*B*4 with add), two of them. B7a and B7c also take their
// cluster geometry (k, threads: codec_cuda.cluster_geometry) and `slots`,
// the ring's depth; a B7a slot holds 32*threads values of the wire dtype
// (4 or 2 bytes each), a B7c slot bits*threads*4 + 256 bytes, whatever tc
// is.

#if CGX_IN_PART(4)
int cgx_quantize_db(const void* x, int32_t* words, float* meta, long long chunks, int tc,
                    int B, int bits, float inv, int encode, int pack, int k, int threads,
                    int slots, int stochastic, unsigned k0, unsigned k1, int wire, void* stream) {
  const uint2 seed = make_uint2(k0, k1);
  return by_instance(stochastic, wire, [&](auto st, auto e) {
    using E = std::remove_const_t<std::remove_pointer_t<decltype(e)>>;
    return cgx::quantize_db_entry<decltype(st)::value, E>(static_cast<const E*>(x), words, meta,
                                                          chunks, tc, B, bits, inv, encode, pack,
                                                          k, threads, slots, seed, wire, stream);
  });
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
int cgx_sra_epilogue_db(const int32_t* words, const float* meta, const void* raw, int own,
                        int ws, long long chunks, int tc, int B, int bits, float inv,
                        int encode, int pack, int k, int threads, int slots, int stochastic,
                        unsigned k0, unsigned k1, int32_t* out_words, float* out_meta, int wire,
                        void* stream) {
  const uint2 seed = make_uint2(k0, k1);
  return by_instance(stochastic, wire, [&](auto st, auto e) {
    using E = std::remove_const_t<std::remove_pointer_t<decltype(e)>>;
    return cgx::sra_epilogue_db_entry<decltype(st)::value, E>(
        words, meta, static_cast<const E*>(raw), own, ws, chunks, tc, B, bits, inv, encode, pack,
        k, threads, slots, seed, out_words, out_meta, wire, stream);
  });
}
#endif

#if CGX_IN_PART(6)
// words: ws rows of chunks*bits*B int32, meta: ws rows of chunks*32*2 f32,
// raw: the own row's chunks*32*B values of the wire dtype (null with own
// == -1) -> out: the reduced chunk, chunks*32*B f32: B4 at width vec (4:
// words, meta and out 16-byte aligned, raw aligned to four of its values,
// B a multiple of 128, each row count 1-8 an instance of its own; 1:
// scalar width, the any-count instance alone), blocks of 128 threads,
// B/(32*vec) a chunk. Static shared memory only, at most 34,816 bytes: no
// attribute to set. Without a raw row `wire` plays no part.
int cgx_reduce_rows(const int32_t* words, const float* meta, const void* raw, int own, int ws,
                    long long chunks, int B, int bits, int vec, float* out, int wire,
                    void* stream) {
  if (raw == nullptr || wire == kWireF32) {
    return cgx::reduce_rows_entry<float>(words, meta, static_cast<const float*>(raw), own, ws,
                                         chunks, B, bits, vec, out, kWireF32, stream);
  }
  if (wire != kWireBf16 && wire != kWireF16) return (int)cudaErrorInvalidValue;
  return cgx::reduce_rows_entry<uint16_t>(words, meta, static_cast<const uint16_t*>(raw), own, ws,
                                          chunks, B, bits, vec, out, wire, stream);
}
#endif

#else  // CGX_INT8
// The int8 fold's entry points: the arguments of cgx_sra_epilogue,
// cgx_sra_epilogue_db and cgx_reduce_rows, the fold in the level domain.
// Every combination the f32 fold's entry points take is built (B4 at the
// any-count instance, whatever the row count).
#if CGX_IN_INT8_PART(0)
int cgx_sra_epilogue_int8(const int32_t* words, const float* meta, const void* raw, int own,
                          int ws, long long chunks, int B, int bits, float inv, int encode,
                          int pack, int k, int threads, int stochastic, unsigned k0, unsigned k1,
                          int32_t* out_words, float* out_meta, int wire, void* stream) {
  const uint2 seed = make_uint2(k0, k1);
  return by_instance(stochastic, wire, [&](auto st, auto e) {
    using E = std::remove_const_t<std::remove_pointer_t<decltype(e)>>;
    return cgx::sra_epilogue_entry<decltype(st)::value, E, kAccumInt8>(
        words, meta, static_cast<const E*>(raw), own, ws, chunks, B, bits, inv, encode, pack, k,
        threads, seed, out_words, out_meta, wire, stream);
  });
}

int cgx_sra_epilogue_db_int8(const int32_t* words, const float* meta, const void* raw, int own,
                             int ws, long long chunks, int tc, int B, int bits, float inv,
                             int encode, int pack, int k, int threads, int slots, int stochastic,
                             unsigned k0, unsigned k1, int32_t* out_words, float* out_meta,
                             int wire, void* stream) {
  const uint2 seed = make_uint2(k0, k1);
  return by_instance(stochastic, wire, [&](auto st, auto e) {
    using E = std::remove_const_t<std::remove_pointer_t<decltype(e)>>;
    return cgx::sra_epilogue_db_entry<decltype(st)::value, E, kAccumInt8>(
        words, meta, static_cast<const E*>(raw), own, ws, chunks, tc, B, bits, inv, encode, pack,
        k, threads, slots, seed, out_words, out_meta, wire, stream);
  });
}

int cgx_reduce_rows_int8(const int32_t* words, const float* meta, const void* raw, int own,
                         int ws, long long chunks, int B, int bits, int vec, float* out, int wire,
                         void* stream) {
  if (raw == nullptr || wire == kWireF32) {
    return cgx::reduce_rows_entry<float, kAccumInt8>(words, meta, static_cast<const float*>(raw),
                                                     own, ws, chunks, B, bits, vec, out, kWireF32,
                                                     stream);
  }
  if (wire != kWireBf16 && wire != kWireF16) return (int)cudaErrorInvalidValue;
  return cgx::reduce_rows_entry<uint16_t, kAccumInt8>(words, meta,
                                                      static_cast<const uint16_t*>(raw), own, ws,
                                                      chunks, B, bits, vec, out, wire, stream);
}
#endif
#endif  // CGX_INT8

}  // extern "C"
