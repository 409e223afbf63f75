// Gather + Gram kernels for BPMF on Hopper (sm_90a): the per-bucket kernel and
// the fused ring-step kernel, over one shared device core.
//
// bpmf_gram_kernel replaces src/repro/kernels/bpmf_gram.py:124
// bpmf_gram_pallas (body _gram_kernel, helper _gather_chunk), the TPU kernel
// on the sequential sampler's path. For a bucket of B items, each with up to
// P neighbor ids into the opposite side's factors X [Ns, K], it computes
//
//     G[b] = sum_{p < nnz[b]} x_{nbr[b,p]} x_{nbr[b,p]}^T          [K, K]
//     g[b] = sum_{p < nnz[b]} val[b,p] * x_{nbr[b,p]}              [K]
//
// bpmf_gram_fused_kernel replaces src/repro/kernels/bpmf_gram.py:245
// bpmf_gram_fused (body _fused_kernel), the TPU kernel of one ring step.
// Over the flattened chunk layout of kernels/ops.py:flatten_step (chunk c
// holds cnt[c] <= pc neighbors of destination row item[c]) it adds, in place,
//
//     G[item] += alpha * sum over the row's chunks of sum_{p < cnt[c]} x x^T
//     g[item] += alpha * sum over the row's chunks of sum_{p < cnt[c]} val * x
//
// once per destination row: the row's partial is summed in float32 and added
// to the running sums once (G need not be symmetric; both G[i][j] and
// G[j][i] get the same partial).
//
// Both compute in float32; with bf16 = 1 every x and val is rounded to
// bfloat16 first and the products are summed in float32, as the JAX kernels'
// bf16 mode does.
//
// What bounds them: per rating K (K + 3) / 2 multiply-adds (560 at K = 32,
// the lower triangle of G plus g) against 8 bytes read (nbr, val); X is read
// through the 50 MB L2 (17.7 MB for the users' factors at MovieLens-20M
// scale, 3.5 MB for the movies'). So the per-bucket kernel is bound by the
// float32 rate (~20 GFLOP per sweep, 0.30 ms at 67 TFLOP/s). The fused
// kernel also reads and writes the running (G, g) row of every destination
// item it touches, and on the users side of the ring those bytes set its
// bound. TF32 tensor cores keep ~10 bits of mantissa and would break the
// 1e-5 agreement the sampler is tested to, so the products run on the FMA
// units; a bf16 mma path, or split TF32 for float32, is not tried here.
//
// What the design does about it:
//  * Heavy rows are split across blocks. A movie of the heavy tail has up to
//    ~10^5 ratings; one block per item left it to one SM while the other
//    131 idled. The per-bucket kernel runs a grid (B, ceil(P / W)): block
//    (b, q) sums ratings [q W, min(nnz[b], (q + 1) W)). An item with
//    nnz <= W is written by its piece 0 directly; the pieces of a longer
//    one write their partial sums (lower triangle plus g, K (K + 3) / 2
//    floats) to scratch, and bpmf_gram_reduce_kernel adds them in ascending
//    piece order and writes G and g. The fused kernel gets the same from
//    the wrapper's piece plan: each block walks at most a fixed number of a
//    row's chunks (a run of the row's ascending chunk list, not of chunk
//    ids, since a row's chunks need not be adjacent); a row with one piece
//    is updated in place, the pieces of a longer row go to scratch and
//    bpmf_gram_fused_reduce_kernel reads the row once, adds the pieces in
//    order, and writes it once. Rows with no live chunk are not touched.
//  * The outer product is register-tiled. A staged tile of gathered rows is
//    Y = [x | val | 0], Kp = round_up(K + 1, 4) columns. Each thread owns a
//    4 x 4 sub-tile of the lower block triangle of Y^T Y and, per staged
//    row, reads two float4 from shared memory for 16 multiply-adds (the
//    previous kernel read two words per multiply-add). At K = 32 there are
//    45 sub-tiles, so in a block of 128 threads 2 teams of 45 take rows
//    t, t + 2, ... of each tile; at the end the teams add their sub-tiles
//    through shared memory in team order. At K >= 60 the sub-tiles
//    outnumber the threads, and one team of 128 threads holds up to 5
//    sub-tiles each (80 sums at K = 128).
//  * Blocks are small (128 threads, 64 registers at K = 32) so that 8 fit
//    on an SM: a block that holds a short row spends most of its life
//    waiting on a chain of dependent loads (piece table, chunk ids, ratings,
//    factor rows, the running row), and more blocks in flight hide it. On
//    an H100 (700 W) 128 threads took a ring users layout of 30.5k short
//    rows from 0.41 to 0.25 ms of device time against 256
//    (scripts/gram_variants.py).
//  * The gather is asynchronous and double-buffered: while a tile is being
//    multiplied, the next one is copied with cp.async (16-byte copies when
//    K % 4 == 0 and X is 16-byte aligned, else 4-byte ones), and the
//    neighbor ids of the tile after that are on their way to registers. One
//    barrier per tile. Hopper's TMA is not used: it copies rectangular
//    tiles, not rows at arbitrary indices.
//  * Every sum runs in a fixed order (rows within a team, teams, pieces),
//    with no atomics, so a launch gives the same bits every time. An
//    out-of-range neighbor id reads NaN, as jnp.take's fill mode does;
//    masked slots, nnz = 0 rows and dead or empty chunks add exact zeros.
//
// Left for later: the running (G, g) rows of the users side of the ring are
// read and written whole (K * K + K floats per row and step), which sets the
// fused kernel's bound there; a packed triangle would halve those bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;     // gathered rows per shared-memory tile
constexpr int kMaxTeams = 8;  // teams share a tile's rows at small K
static_assert(kTile <= kThreads, "one thread loads each row id of a tile");

// ---- asynchronous-copy helpers: all inline PTX of this file is here, so a
// ---- host build of the file (for testing without a GPU) can swap this block.
__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ float4 smem_f4[];
  return reinterpret_cast<float*>(smem_f4);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// ---- end of the asynchronous-copy helpers

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Shapes shared by host and device: the padded row width, the 4 x 4
// sub-tiles of the lower block triangle, the teams, the packed entries.
__host__ __device__ inline int padded_width(int K) { return (K + 4) / 4 * 4; }
__host__ __device__ inline int sub_tiles(int K) {
  const int nb = padded_width(K) / 4;
  return nb * (nb + 1) / 2;
}
__host__ __device__ inline int team_count(int K) {
  const int nt = sub_tiles(K);
  if (nt > kThreads) return 1;
  return kThreads / nt < kMaxTeams ? kThreads / nt : kMaxTeams;
}
// Packed partial sums: G[i][j] (j <= i) at i (i + 1) / 2 + j, then g[i] at
// K (K + 1) / 2 + i.
__host__ __device__ inline int entries(int K) { return K * (K + 3) / 2; }
__host__ __device__ inline int packed(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// Floats of shared memory before the packed partial: two row tiles, which
// the teams reuse to add their sub-tiles at the end.
__host__ __device__ inline int tile_region(int K) {
  const int tiles = 2 * kTile * padded_width(K);
  const int teams = (team_count(K) - 1) * sub_tiles(K) * 16;
  return tiles > teams ? tiles : teams;
}

size_t smem_bytes(int K) {
  // tiles | packed partial [E] | ids [2][kTile] | values [2][kTile]
  return sizeof(float) * (static_cast<size_t>(tile_region(K)) + entries(K) + 4 * kTile);
}

// The rows a block sums: `count()` segments of consecutive slots of nbr/val,
// segment k at offset(k) with size(k) rows.
struct RowRange {  // one run of a bucket row
  size_t start;
  int n;
  __device__ int count() const { return 1; }
  __device__ size_t offset(int) const { return start; }
  __device__ int size(int) const { return n; }
};

struct ChunkList {  // a run of a destination row's chunks, ascending
  const int* ids;
  int len;
  const int* cnt;
  int pc;
  __device__ int count() const { return len; }
  __device__ size_t offset(int k) const { return static_cast<size_t>(ids[k]) * pc; }
  __device__ int size(int k) const { return min(max(cnt[ids[k]], 0), pc); }
};

__device__ __forceinline__ void fma4x4(float (&acc)[16], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(av[i], bv[j], acc[i * 4 + j]);
  }
}

// Sums [x | val]^T [x | val] over the rows of `seg` into the packed partial
// part[0 .. entries(K)) in shared memory, visible to the whole block on
// return. Every thread of the block calls it. MT is the number of sub-tiles
// a thread holds (1 unless sub_tiles(K) > kThreads).
template <int MT, class Seg>
__device__ float* gram_rows(const Seg& seg, const float* __restrict__ X,
                            const int* __restrict__ nbr,
                            const float* __restrict__ val, int Ns, int K,
                            int bf16, int vec4) {
  float* tiles = dynamic_smem();
  const int Kp = padded_width(K);
  const int tri = K * (K + 1) / 2;
  float* part = tiles + tile_region(K);
  int* sid = reinterpret_cast<int*>(part + entries(K));
  float* sval = reinterpret_cast<float*>(sid + 2 * kTile);

  const int tid = threadIdx.x;
  const int NT = sub_tiles(K);
  const int teams = team_count(K);
  const int team_size = NT < kThreads ? NT : kThreads;
  const int team = tid / team_size;  // team >= teams: idle in the product
  int ai[MT], bj[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int s = tid - team * team_size + m * team_size;
    int bi = 0;
    while ((bi + 1) * (bi + 2) / 2 <= s) ++bi;
    ai[m] = s < NT ? 4 * bi : 0;  // past NT: reads row[0..3], result dropped
    bj[m] = s < NT ? 4 * (s - bi * (bi + 1) / 2) : 0;
  }
  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[m][k] = 0.0f;
  }

  // Tiles: kTile rows of one segment at a time. Segment sizes are read by
  // every thread alike, so the tile sequence is uniform across the block.
  int ntiles = 0;
  for (int k = 0; k < seg.count(); ++k) ntiles += (seg.size(k) + kTile - 1) / kTile;
  int ck = 0, cp = 0;  // segment and row of the next tile whose ids are loaded
  while (ck < seg.count() && seg.size(ck) <= 0) ++ck;
  int pre_id = 0, pre_n = 0;
  float pre_val = 0.0f;
  auto load_ids = [&]() {  // the next tile's ids and values -> registers
    pre_n = 0;
    if (ck >= seg.count()) return;
    const int sz = seg.size(ck);
    pre_n = min(kTile, sz - cp);
    if (tid < pre_n) {
      const size_t o = seg.offset(ck) + cp + tid;
      pre_id = nbr[o];
      pre_val = val[o];
    }
    cp += kTile;
    if (cp >= sz) {
      cp = 0;
      ++ck;
      while (ck < seg.count() && seg.size(ck) <= 0) ++ck;
    }
  };
  auto store_ids = [&](int buf) {
    if (tid < pre_n) {
      sid[buf * kTile + tid] = pre_id;
      sval[buf * kTile + tid] = pre_val;
    }
  };
  auto gather = [&](int buf, int n) {  // rows [0, n) of tile buffer `buf`
    float* dst = tiles + buf * kTile * Kp;
    const int* ids = sid + buf * kTile;
    const float* vs = sval + buf * kTile;
    if (vec4) {  // K % 4 == 0: K / 4 float4 of x, then (val, 0, 0, 0)
      const int nq = Kp / 4;
      for (int e = tid; e < n * nq; e += kThreads) {
        const int r = e / nq;
        const int q = e - r * nq;
        float* d = dst + r * Kp + 4 * q;
        if (q < nq - 1) {
          const int idx = ids[r];
          if (idx >= 0 && idx < Ns) {
            cp_async16(d, X + static_cast<size_t>(idx) * K + 4 * q);
          } else {  // an out-of-range id reads NaN, as jnp.take's fill mode does
            *reinterpret_cast<float4*>(d) = make_float4(NAN, NAN, NAN, NAN);
          }
        } else {
          *reinterpret_cast<float4*>(d) = make_float4(vs[r], 0.0f, 0.0f, 0.0f);
        }
      }
    } else {
      for (int e = tid; e < n * Kp; e += kThreads) {
        const int r = e / Kp;
        const int c = e - r * Kp;
        float* d = dst + r * Kp + c;
        if (c < K) {
          const int idx = ids[r];
          if (idx >= 0 && idx < Ns) {
            cp_async4(d, X + static_cast<size_t>(idx) * K + c);
          } else {
            *d = NAN;
          }
        } else {
          *d = c == K ? vs[r] : 0.0f;
        }
      }
    }
    cp_async_commit();
  };

  // Pipeline: while the block multiplies tile t, the rows of tile t + 1 are
  // on their way to shared memory (cp.async) and the ids of tile t + 2 to
  // registers, so each load has a whole tile's product to arrive in.
  load_ids();
  store_ids(0);
  int n_cur = pre_n;
  load_ids();
  __syncthreads();
  if (ntiles > 0) gather(0, n_cur);
  store_ids(1);
  int n_next = pre_n;
  load_ids();
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed, tile t - 1 is consumed, the ids of t + 1 are stored
    if (t + 1 < ntiles) gather((t + 1) & 1, n_next);
    float* cur = tiles + (t & 1) * kTile * Kp;
    if (bf16) {
      for (int e = tid; e < n_cur * Kp; e += kThreads) cur[e] = round_bf16(cur[e]);
      __syncthreads();
    }
    if (team < teams) {
#pragma unroll 4
      for (int r = team; r < n_cur; r += teams) {
        const float* row = cur + r * Kp;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          fma4x4(acc[m], *reinterpret_cast<const float4*>(row + ai[m]),
                 *reinterpret_cast<const float4*>(row + bj[m]));
        }
      }
    }
    store_ids(t & 1);  // ids of tile t + 2 (this buffer's ids, of tile t, are used)
    const int n_after = pre_n;
    load_ids();
    n_cur = n_next;
    n_next = n_after;
  }

  __syncthreads();  // the last tile is consumed: the tile region is free
  if (teams > 1) {  // then MT == 1 and team_size == NT
    float* red = tiles;
    const int s = tid - team * team_size;
    if (team >= 1 && team < teams) {
#pragma unroll
      for (int k = 0; k < 16; ++k) red[((team - 1) * 16 + k) * NT + s] = acc[0][k];
    }
    __syncthreads();
    if (team == 0) {
      for (int t = 1; t < teams; ++t) {
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[0][k] += red[((t - 1) * 16 + k) * NT + s];
      }
    }
  }
  if (team == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (tid + m * team_size >= NT) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int a = ai[m] + i;  // row of Y^T Y
          const int c = bj[m] + j;  // column, c <= a in the lower triangle
          if (c > a) continue;
          if (a < K) {
            part[a * (a + 1) / 2 + c] = acc[m][i * 4 + j];
          } else if (a == K && c < K) {
            part[tri + c] = acc[m][i * 4 + j];  // g: the val row of Y^T Y
          }
        }
      }
    }
  }
  __syncthreads();
  return part;
}

// G[b] (both triangles) and g[b] from a packed partial.
__device__ __forceinline__ void write_gram(float* __restrict__ Gb, float* __restrict__ gb,
                                           const float* part, int K) {
  const int tri = K * (K + 1) / 2;
  for (int e = threadIdx.x; e < K * K; e += kThreads) {
    const int i = e / K;
    Gb[e] = part[packed(i, e - i * K)];
  }
  for (int i = threadIdx.x; i < K; i += kThreads) gb[i] = part[tri + i];
}

// G + alpha * partial, rounded after the product and after the sum, as the
// TPU kernel's `G_ref[...] += alpha * dot(...)` does.
__device__ __forceinline__ void add_gram(float* __restrict__ Gi, float* __restrict__ gi,
                                         const float* part, int K, float alpha) {
  const int tri = K * (K + 1) / 2;
  for (int e = threadIdx.x; e < K * K; e += kThreads) {
    const int i = e / K;
    Gi[e] = __fadd_rn(Gi[e], __fmul_rn(alpha, part[packed(i, e - i * K)]));
  }
  for (int i = threadIdx.x; i < K; i += kThreads) {
    gi[i] = __fadd_rn(gi[i], __fmul_rn(alpha, part[tri + i]));
  }
}

__device__ __forceinline__ void copy_partial(float* __restrict__ dst, const float* part, int K) {
  for (int e = threadIdx.x; e < entries(K); e += kThreads) dst[e] = part[e];
}

// Block (b, q) sums piece q of item b: ratings [q W, min(nnz[b], (q + 1) W)).
// An item with nnz <= W is written by piece 0; the pieces of a longer item
// write partials[b, q, :], which bpmf_gram_reduce_kernel adds.
template <int MT>
__global__ void __launch_bounds__(kThreads)
bpmf_gram_kernel(const float* __restrict__ X, const int* __restrict__ nbr,
                 const float* __restrict__ val, const int* __restrict__ nnz,
                 float* __restrict__ G, float* __restrict__ g,
                 float* __restrict__ partials, int P, int W, int Ns, int K,
                 int bf16, int vec4) {
  const int b = blockIdx.x;
  const int q = blockIdx.y;
  const int n = min(max(nnz[b], 0), P);
  const int lo = q * W;
  if (q > 0 && lo >= n) return;  // past the item's ratings: the reduce skips it
  const RowRange seg{static_cast<size_t>(b) * P + lo, min(n, lo + W) - lo};
  const float* part = gram_rows<MT>(seg, X, nbr, val, Ns, K, bf16, vec4);
  if (n <= W) {
    write_gram(G + static_cast<size_t>(b) * K * K, g + static_cast<size_t>(b) * K, part, K);
  } else {
    copy_partial(partials + (static_cast<size_t>(b) * gridDim.y + q) * entries(K), part, K);
  }
}

// The sum of `count` packed partials, `stride` floats apart, at the entry
// of output e of G (e < K * K) or g (e - K * K), in ascending order.
__device__ __forceinline__ float sum_pieces(const float* __restrict__ src, int count,
                                            size_t stride, int e, int K) {
  const int i = e / K;
  const int pe = e < K * K ? packed(i, e - i * K) : K * (K + 1) / 2 + e - K * K;
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < count; ++k) s += src[k * stride + pe];
  return s;
}

// Items with nnz > W: G[b], g[b] = the sum of their pieces, in ascending q.
// Block (b, y) writes outputs y * kThreads .. of item b, one per thread.
__global__ void __launch_bounds__(kThreads)
bpmf_gram_reduce_kernel(const int* __restrict__ nnz, const float* __restrict__ partials,
                        float* __restrict__ G, float* __restrict__ g, int P, int W,
                        int pieces, int K) {
  const int b = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  const int n = min(max(nnz[b], 0), P);
  if (n <= W || e >= K * K + K) return;
  const int E = entries(K);
  const float s = sum_pieces(partials + static_cast<size_t>(b) * pieces * E, (n + W - 1) / W, E, e, K);
  if (e < K * K) {
    G[static_cast<size_t>(b) * K * K + e] = s;
  } else {
    g[static_cast<size_t>(b) * K + e - K * K] = s;
  }
}

// Block q walks piece q of the wrapper's plan: chunks[start[q] .. + len[q]),
// all of one destination row, ascending. slot[q] < 0: the row has this one
// piece and is updated in place (row item[q]); else the piece's partial goes
// to partials[slot[q], :] for bpmf_gram_fused_reduce_kernel.
template <int MT>
__global__ void __launch_bounds__(kThreads)
bpmf_gram_fused_kernel(float* __restrict__ G, float* __restrict__ g,
                       const float* __restrict__ X, const int* __restrict__ nbr,
                       const float* __restrict__ val, const int* __restrict__ cnt,
                       const int* __restrict__ chunks,
                       const int* __restrict__ piece_start,
                       const int* __restrict__ piece_len,
                       const int* __restrict__ piece_item,
                       const int* __restrict__ piece_slot,
                       float* __restrict__ partials, int pc, int Ns, int K,
                       float alpha, int bf16, int vec4) {
  const int q = blockIdx.x;
  const ChunkList seg{chunks + piece_start[q], piece_len[q], cnt, pc};
  const float* part = gram_rows<MT>(seg, X, nbr, val, Ns, K, bf16, vec4);
  const int slot = piece_slot[q];
  if (slot < 0) {
    const size_t item = static_cast<size_t>(piece_item[q]);
    add_gram(G + item * K * K, g + item * K, part, K, alpha);
  } else {
    copy_partial(partials + static_cast<size_t>(slot) * entries(K), part, K);
  }
}

// Row r of the split rows: its pieces are slots [start[r], start[r] + len[r])
// in chunk order; each entry of the row is read once, gets alpha * (their
// sum), and is written once. Block (r, y) takes entries y * kThreads ..
__global__ void __launch_bounds__(kThreads)
bpmf_gram_fused_reduce_kernel(float* __restrict__ G, float* __restrict__ g,
                              const float* __restrict__ partials,
                              const int* __restrict__ row_item,
                              const int* __restrict__ row_start,
                              const int* __restrict__ row_len, int K, float alpha) {
  const int r = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= K * K + K) return;
  const size_t item = static_cast<size_t>(row_item[r]);
  const int E = entries(K);
  const float s = sum_pieces(partials + static_cast<size_t>(row_start[r]) * E, row_len[r], E, e, K);
  float* dst = e < K * K ? G + item * K * K + e : g + item * K + (e - K * K);
  *dst = __fadd_rn(*dst, __fmul_rn(alpha, s));
}

// Calls f with std::integral_constant<int, MT>, the sub-tiles per thread
// that cover sub_tiles(K) with kThreads threads (5 at K = 128).
template <typename F>
cudaError_t with_mt(int K, F&& f) {
  const int per_thread = (sub_tiles(K) + kThreads - 1) / kThreads;
  if (per_thread <= 1) return f(std::integral_constant<int, 1>{});
  if (per_thread <= 2) return f(std::integral_constant<int, 2>{});
  if (per_thread <= 3) return f(std::integral_constant<int, 3>{});
  return f(std::integral_constant<int, 5>{});
}

// Above 48 KB a kernel must opt in to its dynamic shared memory (K >= 72;
// 100 KB at K = 128).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Launches the per-bucket kernel on `stream` and returns cudaGetLastError()
// (0 = ok). X [Ns, K] f32, nbr [B, P] i32, val [B, P] f32, nnz [B] i32,
// G [B, K, K] f32 and g [B, K] f32 are contiguous device buffers;
// partials [B, pieces, K (K + 3) / 2] f32 is scratch when pieces =
// ceil(P / W) > 1 (else unused). 1 <= K <= 128.
int bpmf_gram_launch(const void* X, const void* nbr, const void* val,
                     const void* nnz, void* G, void* g, void* partials, int B,
                     int P, int W, int pieces, int Ns, int K, int bf16,
                     void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > 128 || W < 1 || pieces < 1 || pieces > 65535 ||
      pieces != (P + W - 1) / W + (P == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const size_t bytes = smem_bytes(K);
  const int vec4 = K % 4 == 0 && aligned16(X);
  const cudaError_t err = with_mt(K, [&](auto mt) {
    auto kernel = bpmf_gram_kernel<decltype(mt)::value>;
    const cudaError_t set = allow_smem(kernel, bytes);
    if (set != cudaSuccess) return set;
    kernel<<<dim3(B, pieces), kThreads, bytes, st>>>(
        static_cast<const float*>(X), static_cast<const int*>(nbr),
        static_cast<const float*>(val), static_cast<const int*>(nnz),
        static_cast<float*>(G), static_cast<float*>(g),
        static_cast<float*>(partials), P, W, Ns, K, bf16, vec4);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// Launches the per-bucket second pass on `stream` (same buffers and W as the
// bpmf_gram_launch before it) and returns cudaGetLastError().
int bpmf_gram_reduce_launch(const void* nnz, const void* partials, void* G,
                            void* g, int B, int P, int W, int pieces, int K,
                            void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > 128 || W < 1 || pieces < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto kernel = bpmf_gram_reduce_kernel;
  const int per_item = (K * K + K + kThreads - 1) / kThreads;
  kernel<<<dim3(B, per_item), kThreads, 0, st>>>(static_cast<const int*>(nnz),
                                 static_cast<const float*>(partials),
                                 static_cast<float*>(G), static_cast<float*>(g),
                                 P, W, pieces, K);
  return static_cast<int>(cudaGetLastError());
}

// Launches the fused ring-step kernel over Q pieces on `stream` and returns
// cudaGetLastError() (0 = ok). G [cap, K, K] f32 and g [cap, K] f32 are
// updated in place; X [Ns, K] f32, nbr [C, pc] i32, val [C, pc] f32,
// cnt [C] i32; chunks [L] i32 and piece_start, piece_len, piece_item,
// piece_slot [Q] i32 are the wrapper's piece plan; partials
// [slots, K (K + 3) / 2] f32 is scratch for the pieces of split rows.
// 1 <= K <= 128.
int bpmf_gram_fused_launch(void* G, void* g, const void* X, const void* nbr,
                           const void* val, const void* cnt, const void* chunks,
                           const void* piece_start, const void* piece_len,
                           const void* piece_item, const void* piece_slot,
                           void* partials, int Q, int pc, int Ns, int K,
                           float alpha, int bf16, void* stream) {
  if (Q <= 0) return 0;
  if (K < 1 || K > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t bytes = smem_bytes(K);
  const int vec4 = K % 4 == 0 && aligned16(X);
  const cudaError_t err = with_mt(K, [&](auto mt) {
    auto kernel = bpmf_gram_fused_kernel<decltype(mt)::value>;
    const cudaError_t set = allow_smem(kernel, bytes);
    if (set != cudaSuccess) return set;
    kernel<<<Q, kThreads, bytes, st>>>(
        static_cast<float*>(G), static_cast<float*>(g),
        static_cast<const float*>(X), static_cast<const int*>(nbr),
        static_cast<const float*>(val), static_cast<const int*>(cnt),
        static_cast<const int*>(chunks), static_cast<const int*>(piece_start),
        static_cast<const int*>(piece_len), static_cast<const int*>(piece_item),
        static_cast<const int*>(piece_slot), static_cast<float*>(partials), pc,
        Ns, K, alpha, bf16, vec4);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// Launches the fused second pass over the R split rows on `stream` and
// returns cudaGetLastError(). row_item, row_start, row_len [R] i32.
int bpmf_gram_fused_reduce_launch(void* G, void* g, const void* partials,
                                  const void* row_item, const void* row_start,
                                  const void* row_len, int R, int K, float alpha,
                                  void* stream) {
  if (R <= 0) return 0;
  if (K < 1 || K > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto kernel = bpmf_gram_fused_reduce_kernel;
  const int per_row = (K * K + K + kThreads - 1) / kThreads;
  kernel<<<dim3(R, per_row), kThreads, 0, st>>>(
      static_cast<float*>(G), static_cast<float*>(g),
      static_cast<const float*>(partials), static_cast<const int*>(row_item),
      static_cast<const int*>(row_start), static_cast<const int*>(row_len), K,
      alpha);
  return static_cast<int>(cudaGetLastError());
}

const char* bpmf_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
