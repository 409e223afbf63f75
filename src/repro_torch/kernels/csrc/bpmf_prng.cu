// Counter-based random numbers for BPMF on Hopper (sm_90a): JAX's threefry2x32
// hash and the draws made from it, one launch per call of core/prng.py.
//
// Replaces no TPU kernel. The JAX package leaves jax.random to XLA, which
// fuses the hash and the float work into one loop; the port's plain version
// (core/prng.py's *_plain functions) runs the hash as ~170 elementwise int64
// launches (20 rounds of add, mask, shift, shift, or, xor, and 5 key
// injections), each reading and writing full-size int64 tensors, plus ~40
// float launches for a normal. prng_keys_kernel computes fold_in and split,
// prng_draw_kernel random_bits, uniform and normal, each in one pass.
//
// What bounds them: instruction dispatch. In the sm_90a SASS a thread of a
// normal draw executes 223 instructions on its common path: 94 on the integer
// ALU pipe (the hash's adds, funnel shifts and xors, compares), 37 IMAD, 41
// float32 (log1pf and the erfinv polynomial), 3 MUFU and conversions (the
// row division), the rest loads, stores, constant loads and control; a
// fold_in thread executes 140. At 128 thread-instructions a clock on each of
// the H100's 132 SMs a normal takes ~5x the time of writing its 4 bytes at
// 3.35 TB/s (chip_smoke.py's bound counts the same).
// What the design does about it: one thread per output, the hash in
// registers as uint32, rotations with __funnelshift_l; the key is read once
// per thread, and the threads of one key row read the same two words (one
// broadcast load: at K = 32 a warp shares a key); writes are coalesced; no
// int64 intermediate reaches device memory.
//
// The draws are the plain ops' bits on the card, not a new generator: the
// same hash, and floats by the same roundings. Where the plain path runs a
// separate multiply and add (two PyTorch kernels), this one calls
// __fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA; log1pf
// and sqrtf are what PyTorch's float kernels call for log1p and sqrt; the
// float32 scalars (the uniform's scale and low end, sqrt(2)) come from the
// wrapper, computed as the plain path computes them.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;  // 16.7 M threads; larger calls stride
constexpr uint32_t kParity = 0x1BD11BDAu;

enum Kind { kBits = 0, kUniform = 1, kNormal = 2 };

// Giles' single-precision erfinv as XLA expands erf_inv for float32: the
// float32 values of core/prng.py's _ERFINV_SMALL and _ERFINV_LARGE
// (tests/test_torch_prng.py holds the two lists equal).
__constant__ float kErfinvSmall[9] = {
    2.8102264e-08f, 3.4327394e-07f, -3.5233877e-06f, -4.3915065e-06f, 0.00021858087f,
    -0.001253725f, -0.0041776816f, 0.24664073f, 1.5014094f,
};
__constant__ float kErfinvLarge[9] = {
    -0.00020021426f, 0.00010095056f, 0.0013493432f, -0.0036734284f, 0.0057395077f,
    -0.0076224613f, 0.0094388705f, 1.001674f, 2.8329768f,
};

struct Words {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// Four rounds of threefry2x32 with rotations r0..r3.
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// threefry2x32 (20 rounds) of counter (x0, x1) under key (k0, k1): the
// plain threefry2x32 of core/prng.py, on uint32 words.
__device__ __forceinline__ Words threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return {x0, x1};
}

// core/prng.py:uniform_plain on one word: the top 23 bits as a mantissa in
// [1, 2), minus one, times scale plus lo, clamped below at lo.
__device__ __forceinline__ float uniform_from(uint32_t bits, float scale, float lo) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(__fadd_rn(__fmul_rn(f, scale), lo), lo);
}

// core/prng.py:erfinv: XLA's float32 polynomial, with its |x| == 1 edge.
__device__ __forceinline__ float erfinv_xla(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  const bool small = w < 5.0f;
  w = small ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = small ? kErfinvSmall[0] : kErfinvLarge[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) {
    p = __fadd_rn(small ? kErfinvSmall[j] : kErfinvLarge[j], __fmul_rn(p, w));
  }
  return fabsf(x) == 1.0f ? __fmul_rn(x, FLT_MAX) : __fmul_rn(p, x);
}

// Output row r of `rows * max(n, 1)`: base row b = r / n and, for split
// (n >= 1), counter j = r % n; for fold_in (n == 0) the counter is
// ctr[b * ctr_stride] (ctr_bytes 4 or 8: its low 32 bits) or ctr_scalar
// (ctr_bytes 0). The key is keys[b * key_stride]; strides are 0 (one key or
// counter for every row) or 1. out [rows * max(n, 1), 2] int64.
__global__ void __launch_bounds__(kThreads) prng_keys_kernel(
    const int64_t* __restrict__ keys, long long key_stride, const void* __restrict__ ctr,
    int ctr_bytes, long long ctr_stride, uint32_t ctr_scalar, long long rows, long long n,
    longlong2* __restrict__ out) {
  const long long total = rows * (n > 0 ? n : 1);
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; r < total;
       r += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long b = r;
    uint32_t c = ctr_scalar;
    if (n > 0) {
      b = r / n;
      c = static_cast<uint32_t>(r - b * n);
    } else if (ctr_bytes == 4) {
      c = static_cast<uint32_t>(static_cast<const int32_t*>(ctr)[b * ctr_stride]);
    } else if (ctr_bytes == 8) {
      c = static_cast<uint32_t>(static_cast<const int64_t*>(ctr)[b * ctr_stride]);
    }
    const int64_t* k = keys + 2 * b * key_stride;
    const Words y = threefry2x32(static_cast<uint32_t>(k[0]), static_cast<uint32_t>(k[1]), 0u, c);
    out[r] = make_longlong2(y.a, y.b);
  }
}

// Output o of `rows * n`: key row m = o / n, counter i = o % n hashed as
// (i >> 32, i & 0xffffffff), the two words xor'ed. Kind kBits writes them as
// int64; kUniform the float32 uniform on [lo, lo + scale); kNormal
// post * erfinv of that uniform (post = sqrt(2)).
template <int kKind>
__global__ void __launch_bounds__(kThreads) prng_draw_kernel(
    const int64_t* __restrict__ keys, long long rows, long long n, float scale, float lo, float post,
    void* __restrict__ out) {
  const long long total = rows * n;
  for (long long o = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; o < total;
       o += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long m = 0, i = o;
    if (rows > 1) {
      if (total <= 0xFFFFFFFFll) {  // the cheap 32-bit division where it fits
        m = static_cast<uint32_t>(o) / static_cast<uint32_t>(n);
      } else {
        m = o / n;
      }
      i = o - m * n;
    }
    const int64_t* k = keys + 2 * m;
    const Words y = threefry2x32(static_cast<uint32_t>(k[0]), static_cast<uint32_t>(k[1]),
                                 static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32),
                                 static_cast<uint32_t>(i));
    const uint32_t bits = y.a ^ y.b;
    if (kKind == kBits) {
      static_cast<int64_t*>(out)[o] = static_cast<int64_t>(bits);
    } else if (kKind == kUniform) {
      static_cast<float*>(out)[o] = uniform_from(bits, scale, lo);
    } else {
      static_cast<float*>(out)[o] = __fmul_rn(post, erfinv_xla(uniform_from(bits, scale, lo)));
    }
  }
}

unsigned grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

// fold_in (n == 0) or split (n >= 1) of `rows` key rows on `stream`; returns
// cudaGetLastError() (0 = ok). keys [*, 2] int64 words below 2^32 and ctr
// (ctr_bytes 4: int32, 8: int64, 0: none, ctr_scalar instead) are
// contiguous device buffers; out [rows * max(n, 1), 2] int64.
int bpmf_prng_keys_launch(const void* keys, long long key_stride, const void* ctr, int ctr_bytes,
                          long long ctr_stride, unsigned int ctr_scalar, long long rows, long long n,
                          void* out, void* stream) {
  const long long total = rows * (n > 0 ? n : 1);
  if (total <= 0) return 0;
  if (key_stride < 0 || key_stride > 1 || ctr_stride < 0 || ctr_stride > 1 ||
      (n == 0 && ctr_bytes != 0 && ctr_bytes != 4 && ctr_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  prng_keys_kernel<<<grid_for(total), kThreads, 0, st>>>(
      static_cast<const int64_t*>(keys), key_stride, ctr, ctr_bytes, ctr_stride, ctr_scalar, rows, n,
      static_cast<longlong2*>(out));
  return static_cast<int>(cudaGetLastError());
}

// `n` draws for each of `rows` key rows on `stream`; returns
// cudaGetLastError(). keys [rows, 2] int64; out [rows * n] int64 (kind 0,
// bits) or float32 (1, uniform; 2, normal), contiguous device buffers.
int bpmf_prng_draw_launch(const void* keys, long long rows, long long n, int kind, float scale,
                          float lo, float post, void* out, void* stream) {
  const long long total = rows * n;
  if (total <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto k = static_cast<const int64_t*>(keys);
  switch (kind) {
    case kBits:
      prng_draw_kernel<kBits><<<grid_for(total), kThreads, 0, st>>>(k, rows, n, scale, lo, post, out);
      break;
    case kUniform:
      prng_draw_kernel<kUniform><<<grid_for(total), kThreads, 0, st>>>(k, rows, n, scale, lo, post, out);
      break;
    case kNormal:
      prng_draw_kernel<kNormal><<<grid_for(total), kThreads, 0, st>>>(k, rows, n, scale, lo, post, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bpmf_prng_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
