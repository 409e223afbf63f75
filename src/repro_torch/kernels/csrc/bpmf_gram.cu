// Gather + Gram kernels for BPMF on Hopper (sm_90a): the per-bucket kernel and
// the fused ring-step kernel.
//
// bpmf_gram_kernel replaces src/repro/kernels/bpmf_gram.py:bpmf_gram_pallas
// (body _gram_kernel, helper _gather_chunk), the TPU kernel on the sequential
// sampler's path. For a bucket of B items, each with up to P neighbor ids into
// the opposite side's factors X [Ns, K], it computes
//
//     G[b] = sum_{p < nnz[b]} x_{nbr[b,p]} x_{nbr[b,p]}^T          [K, K]
//     g[b] = sum_{p < nnz[b]} val[b,p] * x_{nbr[b,p]}              [K]
//
// bpmf_gram_fused_kernel replaces src/repro/kernels/bpmf_gram.py:
// bpmf_gram_fused (body _fused_kernel), the TPU kernel of one ring step.
// Over the flattened chunk layout of kernels/ops.py:flatten_step (chunk c
// holds cnt[c] <= pc neighbors of destination row item[c]) it adds, in place,
//
//     G[item[c]] += alpha * sum_{p < cnt[c]} x x^T,
//     g[item[c]] += alpha * sum_{p < cnt[c]} val * x        for every chunk c,
//
// one float32 add of alpha * (chunk partial) per chunk, in ascending c, as the
// TPU kernel's grid does.
//
// Both compute in float32; with bf16 = 1 every x and val is rounded to
// bfloat16 first and the products are summed in float32, as the JAX kernels'
// bf16 mode does.
//
// What bounds them: per rating K (K + 3) / 2 multiply-adds (1,120 flops at
// K = 32) against 8 bytes read (nbr, val); X is read once per launch (held in
// the 50 MB L2). The per-bucket kernel writes [B, K, K] + [B, K] once; at
// MovieLens-20M scale the f32 rate sets its bound (~20 GFLOP, 0.30 ms at
// 67 TFLOP/s, against ~0.73 GB, 0.22 ms at 3.35 TB/s, for the users side).
// The fused kernel reads and writes the running (G, g) row of every
// destination item it touches: with S ring shards the users side moves
// ~34.6k rows x 4.2 KB x 2 per launch at S = 4 for ~1.1 M ratings, so there
// the bytes of G and g set the bound. TF32 tensor cores would break the
// 1e-5 agreement the sampler is tested to.
//
// What the design does about it:
//  * The TPU kernels gather neighbor rows with a one-hot matrix product on
//    the MXU over a VMEM-resident shard streamed in ns_chunk slices; here a
//    block gathers rows directly, K + 1 words each (the TPU kernel's own
//    docstring calls this the natural GPU form), and there is no Ns axis.
//  * G is symmetric, so only the lower triangle and g are accumulated:
//    K (K + 3) / 2 sums instead of K (K + 1), half the multiply-adds.
//  * Only the real neighbors are read; masked padding costs nothing.
//  * One block owns one item and walks its neighbors in chunks of kChunk
//    rows staged in shared memory as [x | val]; each thread owns up to MAXE
//    entries of the output and keeps them in registers. Every entry is summed
//    in increasing p by one thread and written once: no atomics, and the
//    result is the same bits on every run.
//  * The fused kernel keeps that: one block owns one destination row and
//    walks the row's chunks in ascending c (a list the wrapper builds once
//    per layout, since an item may own several chunks, not all adjacent).
//    It reads G[item] and g[item] once, adds each chunk's partial in
//    registers, and writes the row once. Rows with no live chunk are not
//    touched; dead chunks (item = -1) and empty ones (cnt = 0) add exact
//    zeros, so the list leaves them out.
//
// Left for later: one block per item leaves the heaviest item (tens of
// thousands of ratings) to one SM, and each multiply-add reads two words of
// shared memory; splitting long rows across blocks and register tiling are
// the first steps to make them fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Entry s of thread tid: e = tid + s * kThreads. Entry e < tri is G[i][j]
// with j <= i (row-major lower triangle); entry tri + i is g[i] = sum x_i *
// val, i.e. column K of [x | val]. Entries past E are idle (i = j = 0).
template <int MAXE>
__device__ __forceinline__ void entry_indices(int tid, int K, int (&ei)[MAXE],
                                              int (&ej)[MAXE]) {
  const int tri = K * (K + 1) / 2;
  const int E = tri + K;
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
  }
}

// acc[s] += sum over the n rows (nb[p], vb[p]) of [x | val]_i [x | val]_j, in
// increasing p, staged kChunk rows at a time in shared memory. Every thread
// of the block calls it with the same n.
template <int MAXE>
__device__ __forceinline__ void accumulate_rows(
    float (&acc)[MAXE], const int (&ei)[MAXE], const int (&ej)[MAXE],
    float* rows, const float* __restrict__ X, const int* __restrict__ nb,
    const float* __restrict__ vb, int n, int Ns, int K, int bf16) {
  const int tid = threadIdx.x;
  const int W = K + 1;
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
  const int tri = K * (K + 1) / 2;  // lower-triangle entries of G
  const int E = tri + K;            // plus the K entries of g

  int ei[MAXE], ej[MAXE];
  float acc[MAXE];
  entry_indices<MAXE>(tid, K, ei, ej);
#pragma unroll
  for (int s = 0; s < MAXE; ++s) acc[s] = 0.0f;

  const int n = min(max(nnz[b], 0), P);
  accumulate_rows<MAXE>(acc, ei, ej, rows, X, nbr + static_cast<size_t>(b) * P,
                        val + static_cast<size_t>(b) * P, n, Ns, K, bf16);

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

// One block per destination row: block r owns row seg_item[r] and its chunks
// chunks[seg_start[r] .. seg_start[r] + seg_len[r]), in ascending chunk id.
// G and g are updated in place; each entry of the row belongs to one thread.
template <int MAXE>
__global__ void __launch_bounds__(kThreads)
bpmf_gram_fused_kernel(float* __restrict__ G, float* __restrict__ g,
                       const float* __restrict__ X, const int* __restrict__ nbr,
                       const float* __restrict__ val, const int* __restrict__ cnt,
                       const int* __restrict__ seg_item,
                       const int* __restrict__ seg_start,
                       const int* __restrict__ seg_len,
                       const int* __restrict__ chunks, int pc, int Ns, int K,
                       float alpha, int bf16) {
  extern __shared__ float rows[];  // [kChunk, K + 1]: gathered x, then val
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int tri = K * (K + 1) / 2;
  const int E = tri + K;
  float* Gi = G + static_cast<size_t>(seg_item[r]) * K * K;
  float* gi = g + static_cast<size_t>(seg_item[r]) * K;

  int ei[MAXE], ej[MAXE];
  entry_indices<MAXE>(tid, K, ei, ej);
  // running values of G[i][j], G[j][i] (G need not be symmetric) and g[i]
  float lo[MAXE], hi[MAXE], acc[MAXE];
#pragma unroll
  for (int s = 0; s < MAXE; ++s) {
    const int e = tid + s * kThreads;
    lo[s] = 0.0f;
    hi[s] = 0.0f;
    if (e < tri) {
      lo[s] = Gi[ei[s] * K + ej[s]];
      hi[s] = Gi[ej[s] * K + ei[s]];
    } else if (e < E) {
      lo[s] = gi[ei[s]];
    }
  }

  const int first = seg_start[r];
  const int count = seg_len[r];
  for (int k = 0; k < count; ++k) {
    const size_t c = static_cast<size_t>(chunks[first + k]);
    const int n = min(max(cnt[c], 0), pc);
#pragma unroll
    for (int s = 0; s < MAXE; ++s) acc[s] = 0.0f;
    accumulate_rows<MAXE>(acc, ei, ej, rows, X, nbr + c * pc, val + c * pc, n,
                          Ns, K, bf16);
    // G + alpha * partial, rounded after the product and after the sum, as
    // the TPU kernel's `G_ref[...] += alpha * dot(...)` does
#pragma unroll
    for (int s = 0; s < MAXE; ++s) {
      const float add = __fmul_rn(alpha, acc[s]);
      lo[s] = __fadd_rn(lo[s], add);
      hi[s] = __fadd_rn(hi[s], add);
    }
  }

#pragma unroll
  for (int s = 0; s < MAXE; ++s) {
    const int e = tid + s * kThreads;
    if (e < tri) {
      Gi[ei[s] * K + ej[s]] = lo[s];
      Gi[ej[s] * K + ei[s]] = hi[s];
    } else if (e < E) {
      gi[ei[s]] = lo[s];
    }
  }
}

// Calls f with std::integral_constant<int, MAXE>, the smallest of the
// instantiated entries-per-thread counts that covers K (K + 3) / 2 entries.
template <typename F>
cudaError_t with_maxe(int K, F&& f) {
  const int per_thread = (K * (K + 3) / 2 + kThreads - 1) / kThreads;
  if (per_thread <= 1) return f(std::integral_constant<int, 1>{});
  if (per_thread <= 3) return f(std::integral_constant<int, 3>{});
  if (per_thread <= 8) return f(std::integral_constant<int, 8>{});
  if (per_thread <= 17) return f(std::integral_constant<int, 17>{});
  return f(std::integral_constant<int, 33>{});
}

size_t rows_bytes(int K) {
  return static_cast<size_t>(kChunk) * (K + 1) * sizeof(float);
}

}  // namespace

extern "C" {

// Launches the per-bucket kernel on `stream` and returns cudaGetLastError()
// (0 = ok). X [Ns, K] f32, nbr [B, P] i32, val [B, P] f32, nnz [B] i32,
// G [B, K, K] f32 and g [B, K] f32 are contiguous device buffers;
// 1 <= K <= 128.
int bpmf_gram_launch(const void* X, const void* nbr, const void* val,
                     const void* nnz, void* G, void* g, int B, int P, int Ns,
                     int K, int bf16, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_maxe(K, [&](auto maxe) {
    bpmf_gram_kernel<decltype(maxe)::value><<<B, kThreads, rows_bytes(K), st>>>(
        static_cast<const float*>(X), static_cast<const int*>(nbr),
        static_cast<const float*>(val), static_cast<const int*>(nnz),
        static_cast<float*>(G), static_cast<float*>(g), P, Ns, K, bf16);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// Launches the fused ring-step kernel on `stream` and returns
// cudaGetLastError() (0 = ok). G [cap, K, K] f32 and g [cap, K] f32 are
// updated in place; X [Ns, K] f32, nbr [C, pc] i32, val [C, pc] f32,
// cnt [C] i32; seg_item, seg_start, seg_len [R] i32 and chunks [L] i32 are
// the wrapper's item -> chunk list (distinct seg_item rows). 1 <= K <= 128.
int bpmf_gram_fused_launch(void* G, void* g, const void* X, const void* nbr,
                           const void* val, const void* cnt,
                           const void* seg_item, const void* seg_start,
                           const void* seg_len, const void* chunks, int R,
                           int pc, int Ns, int K, float alpha, int bf16,
                           void* stream) {
  if (R <= 0) return 0;
  if (K < 1 || K > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_maxe(K, [&](auto maxe) {
    bpmf_gram_fused_kernel<decltype(maxe)::value>
        <<<R, kThreads, rows_bytes(K), st>>>(
            static_cast<float*>(G), static_cast<float*>(g),
            static_cast<const float*>(X), static_cast<const int*>(nbr),
            static_cast<const float*>(val), static_cast<const int*>(cnt),
            static_cast<const int*>(seg_item),
            static_cast<const int*>(seg_start),
            static_cast<const int*>(seg_len), static_cast<const int*>(chunks),
            pc, Ns, K, alpha, bf16);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

const char* bpmf_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
