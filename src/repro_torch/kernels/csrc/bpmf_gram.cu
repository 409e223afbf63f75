// Per-bucket gather + Gram kernel for BPMF on Hopper (sm_90a).
//
// Replaces src/repro/kernels/bpmf_gram.py:bpmf_gram_pallas (body _gram_kernel,
// helper _gather_chunk), the TPU kernel on the sequential sampler's path.
// For a bucket of B items, each with up to P neighbor ids into the opposite
// side's factors X [Ns, K], it computes
//
//     G[b] = sum_{p < nnz[b]} x_{nbr[b,p]} x_{nbr[b,p]}^T          [K, K]
//     g[b] = sum_{p < nnz[b]} val[b,p] * x_{nbr[b,p]}              [K]
//
// in float32; with bf16 = 1 every x and val is rounded to bfloat16 first and
// the products are summed in float32, as the JAX kernel's bf16 mode does.
//
// What bounds it: float32 arithmetic. Per rating it does K (K + 3) / 2
// multiply-adds (1,120 flops at K = 32) and must read 8 bytes (nbr, val);
// X itself is read once per launch (3.5 MB to 18 MB at MovieLens scale,
// held in the 50 MB L2). With the [B, K, K] + [B, K] output written once,
// the users side of a MovieLens-20M sweep moves ~0.73 GB (0.22 ms at
// 3.35 TB/s) against ~20 GFLOP (0.30 ms at 67 TFLOP/s without tensor
// cores), so the f32 rate sets the bound; TF32 tensor cores would break
// the 1e-5 agreement the sampler is tested to.
//
// What the design does about it:
//  * The TPU kernel gathers neighbor rows with a one-hot matrix product on
//    the MXU; here each block gathers rows directly, K + 1 words each
//    (the TPU kernel's own docstring calls this the natural GPU form).
//  * G is symmetric, so only the lower triangle and g are accumulated:
//    K (K + 3) / 2 sums instead of K (K + 1), half the multiply-adds.
//  * Only the nnz[b] real neighbors are read; masked padding, about half of
//    the padded slots at MovieLens scale, costs nothing.
//  * One block owns one item and walks its neighbors in chunks of CHUNK rows
//    staged in shared memory as [x | val]; each thread owns up to MAXE
//    entries of the output and keeps them in registers. Every entry is summed
//    in increasing p by one thread and written once: no atomics, and the
//    result is the same bits on every run.
//
// Left for later: one block per item leaves the heaviest item (tens of
// thousands of ratings) to one SM, and each multiply-add reads two words of
// shared memory; splitting long rows across blocks and register tiling are
// the first steps to make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MAXE>
__global__ void __launch_bounds__(kThreads)
bpmf_gram_kernel(const float* __restrict__ X, const int* __restrict__ nbr,
                 const float* __restrict__ val, const int* __restrict__ nnz,
                 float* __restrict__ G, float* __restrict__ g, int P, int Ns,
                 int K, int bf16) {
  extern __shared__ float rows[];  // [kChunk, K + 1]: gathered x, then val
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = K + 1;
  const int tri = K * (K + 1) / 2;  // lower-triangle entries of G
  const int E = tri + K;            // plus the K entries of g

  // entry e < tri is G[i][j] with j <= i (row-major lower triangle);
  // entry tri + i is g[i] = sum x_i * val, i.e. column K of [x | val]
  int ei[MAXE], ej[MAXE];
  float acc[MAXE];
#pragma unroll
  for (int s = 0; s < MAXE; ++s) {
    const int e = tid + s * kThreads;
    int i = 0, j = 0;
    if (e < tri) {
      i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
      while (i * (i + 1) / 2 > e) --i;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
      j = e - i * (i + 1) / 2;
    } else if (e < E) {
      i = e - tri;
      j = K;
    }
    ei[s] = i;
    ej[s] = j;
    acc[s] = 0.0f;
  }

  const int n = min(max(nnz[b], 0), P);
  const int* nb = nbr + static_cast<size_t>(b) * P;
  const float* vb = val + static_cast<size_t>(b) * P;

  for (int p0 = 0; p0 < n; p0 += kChunk) {
    const int rows_here = min(kChunk, n - p0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int t = tid; t < rows_here * W; t += kThreads) {
      const int r = t / W;
      const int c = t - r * W;
      float v;
      if (c < K) {
        const int idx = nb[p0 + r];
        // an out-of-range id reads NaN, as jnp.take's fill mode does
        v = (idx >= 0 && idx < Ns) ? X[static_cast<size_t>(idx) * K + c] : NAN;
      } else {
        v = vb[p0 + r];
      }
      rows[t] = bf16 ? round_bf16(v) : v;
    }
    __syncthreads();
    for (int r = 0; r < rows_here; ++r) {
      const float* row = rows + r * W;
#pragma unroll
      for (int s = 0; s < MAXE; ++s) {
        acc[s] = fmaf(row[ei[s]], row[ej[s]], acc[s]);
      }
    }
  }

  float* Gb = G + static_cast<size_t>(b) * K * K;
  float* gb = g + static_cast<size_t>(b) * K;
#pragma unroll
  for (int s = 0; s < MAXE; ++s) {
    const int e = tid + s * kThreads;
    if (e < tri) {
      Gb[ei[s] * K + ej[s]] = acc[s];
      Gb[ej[s] * K + ei[s]] = acc[s];
    } else if (e < E) {
      gb[ei[s]] = acc[s];
    }
  }
}

template <int MAXE>
cudaError_t launch(const float* X, const int* nbr, const float* val,
                   const int* nnz, float* G, float* g, int B, int P, int Ns,
                   int K, int bf16, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kChunk) * (K + 1) * sizeof(float);
  bpmf_gram_kernel<MAXE><<<B, kThreads, smem, stream>>>(X, nbr, val, nnz, G, g,
                                                       P, Ns, K, bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// X [Ns, K] f32, nbr [B, P] i32, val [B, P] f32, nnz [B] i32, G [B, K, K]
// f32 and g [B, K] f32 are contiguous device buffers; 1 <= K <= 128.
int bpmf_gram_launch(const void* X, const void* nbr, const void* val,
                     const void* nnz, void* G, void* g, int B, int P, int Ns,
                     int K, int bf16, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > 128) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(X);
  const auto* nb = static_cast<const int*>(nbr);
  const auto* v = static_cast<const float*>(val);
  const auto* nz = static_cast<const int*>(nnz);
  auto* Go = static_cast<float*>(G);
  auto* go = static_cast<float*>(g);
  auto st = static_cast<cudaStream_t>(stream);
  const int per_thread = (K * (K + 3) / 2 + kThreads - 1) / kThreads;
  cudaError_t err;
  if (per_thread <= 1) {
    err = launch<1>(x, nb, v, nz, Go, go, B, P, Ns, K, bf16, st);
  } else if (per_thread <= 3) {
    err = launch<3>(x, nb, v, nz, Go, go, B, P, Ns, K, bf16, st);
  } else if (per_thread <= 8) {
    err = launch<8>(x, nb, v, nz, Go, go, B, P, Ns, K, bf16, st);
  } else if (per_thread <= 17) {
    err = launch<17>(x, nb, v, nz, Go, go, B, P, Ns, K, bf16, st);
  } else {
    err = launch<33>(x, nb, v, nz, Go, go, B, P, Ns, K, bf16, st);
  }
  return static_cast<int>(err);
}

const char* bpmf_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
