// Fused distance x cluster-label sums for Hopper (sm_90a), plain C ABI.
//
//   S[i, k] = sum_{j, c : labels[j, c] == k} ||x_i - x_j||
//
//   x (N, d) fp32, labels (N, C) int32 (one cluster id per cut, ids of
//   different cuts in disjoint ranges of [0, K); an id outside [0, K) is
//   no cluster), S (N, K) fp32.
//
// Replaces the TPU kernel scconsensus_tpu/ops/pallas_kernels.py `_kernel`
// (launched by `_dist_sums_pallas`), the silhouette stage's one fused pass:
// row norms, the cross product, sqrt(max(a^2 + b^2 - 2ab, 0)) and the
// reduction into clusters, with the (N, N) distance matrix never stored.
// The TPU kernel multiplies the distance tile by a dense (N, K) one-hot on
// the matrix unit. That one-hot holds one 1 per cell and cut (C of K
// entries), so here each distance is added to its C clusters: C adds a
// pair instead of the one-hot product's 2K (898 against 4 on the 26k path).
//
// What bounds it on this card: operations. The work is N^2 * (2d + 3)
// fp32 operations for the distances plus N^2 * C adds into clusters
// (2.5e10 at N = 26,000, d = 15, C = 4), against N * (d + C + K) * 4 bytes
// (49 MB at K = 449) read and written once, so the floor is the fp32
// CUDA-core rate. The kernel this one replaces spent its time elsewhere:
// every (pair, cut) was a read-add-write of a sum in shared memory, those
// sums capped the blocks an SM could hold, and with one cut three of its
// four warps had nothing to add.
//
// What the design does about it:
//  1. Cells in cluster order. The columns j come sorted by their ids
//     (cut 0, then cut 1 inside each cut-0 group, ...): keys_kernel packs
//     each cell's ids into one int64, the host sorts them (a stable
//     torch.argsort), and prepare_kernel lays out a padded copy of x in
//     that order with its norms, the ids, and for every cell a bit mask of
//     the cuts whose run of equal ids ends there. Rows i keep the caller's
//     order. The sum over j does not depend on its order. Below 2,048
//     cells the host keeps the caller's order: there the sort costs more
//     than the sweep it shortens.
//  2. Run sums in registers. Every thread of a block walks the same
//     ordered cells, so where a cut's run ends is the same for the whole
//     block: a warp's ballot turns a tile's run-end masks into 32 bits per
//     cut, and every branch on them is uniform, not divergent. A thread
//     adds each distance to one register per (row, cut) and writes the
//     register out only when the run ends: a row costs one write per run
//     (exactly K with one cut; K on the 26k path's four nested cuts), not
//     one read-add-write per (cell, cut). Each pair's distance is computed
//     once for all cuts. A tile, or a group of 8 cells, with no run end
//     adds its sum at once; a group with one is walked cell by cell from
//     shared memory. Random ids in a later cut make runs of one cell, and
//     there a write per (cell, cut) remains.
//  3. All warps busy for any C: the work is split by rows (a thread owns
//     R = 2 rows, a block TM = 256) and by ranges of j (grid.y = splits),
//     never by cut.
//  4. No sums held in shared memory for the sweep. A run's register is
//     added into a partial sum part[split][k][i] in device memory: lanes
//     hold consecutive rows, so a warp's write is one 128-byte line, and
//     the add is a reduction that does not wait for the old value
//     (red.global.add). A second small kernel adds the splits' partials in
//     a fixed order and writes S (N, K) through a shared-memory transpose;
//     with one split the sweep adds into S directly. Shared memory holds
//     the staged tiles and a walk's distances (at most 18 KB a block), so
//     registers alone set how many blocks share an SM.
//  5. Asynchronous staging. Each tile of TN = 32 ordered cells (features,
//     norms, run masks, ids) is copied with cp.async into the second of two
//     buffers while the threads compute on the first; nobody stands aside
//     to load.
//  6. Parallelism: enough warps and enough independent work. Rows alone
//     give only N / 64 warps (407 at N = 26,000), so the host splits j
//     into ranges until the blocks fill the SMs' block slots evenly
//     (splits, from the occupancy calculator), and each thread keeps the
//     cross products of its 2 rows with all TN cells of a tile in
//     registers: 64 independent FMA chains in flight, one broadcast load
//     of 4 features feeding 8 FMAs.
//  7. Deterministic. The only atomics are the red.global.add flushes of
//     point 4, and every address they touch has one writer thread: PTX's
//     coherence order keeps one thread's operations on one address in
//     program order, so each partial sum is taken in the same order on
//     every run. Cut groups run one after another on the stream, and the
//     splits are added in a fixed order. chip_smoke.py checks that a
//     second launch gives the same bits and prints the difference.
//  8. fp32 FMA on the CUDA cores for the cross product, not the tensor
//     cores. With d = 15 the product is two TF32 k-steps, and TF32 keeps
//     about three decimal digits, where the port keeps full fp32 (TF32 is
//     off, device.py). A split 3xTF32 product on the tensor cores would
//     save only the 15 FMAs of a pair; the epilogue (sqrt, max and the C
//     adds) stays on the CUDA cores either way. A later kernel that moves
//     the product to wgmma must also count tensor-core work in the bound
//     (chip_smoke.py `_bound` counts fp32 CUDA-core operations only). The
//     square root is the one-instruction sqrt.approx.ftz.f32 (a few ulp
//     from the IEEE result); a distance's rounding differs from the plain
//     version's by that much, far inside the 1e-4 of the largest sum the
//     two are held to.
// Features are padded to DC = 16 (d <= 16) or taken in chunks of DC = 32;
// cuts to NC = 1, 2 or 4 (padding cuts hold id -1 and add nothing; more
// than 4 cuts take one sweep a group). Ragged rows and cells are masked or
// padded; ids outside [0, K) form runs that are never written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int R = 2;               // rows per thread
constexpr int THREADS = 128;
constexpr int TM = R * THREADS;    // rows per block
constexpr int TN = 32;             // ordered cells per staged tile: a warp's
                                   // ballot holds one tile's run ends
constexpr unsigned FULL = 0xffffffffu;
static_assert(TN == 32 && TN % 4 == 0, "one ballot bit per cell of a tile");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// sums[0] += v without waiting for the old value (red.global.add.f32).
// Each address has one writer thread, and PTX's coherence order keeps one
// thread's operations on one address in program order, so the sum is
// taken in the same order on every run.
__device__ __forceinline__ void add_to(float* sums, float v) {
  atomicAdd(sums, v);
}
__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// xs (Q, np, DC) ordered features in chunks of DC, b2s (np) their norms,
// ends (np) run-end masks, ids (np, NC), from prepare_kernel. The run sums
// of row i and cluster g go to sums[blockIdx.y * k * n + g * stride_k +
// i * stride_i]: the partial sums part (splits, k, n), or S (n, k) itself
// when j is not split. Thread t owns rows blockIdx.x * TM + r * THREADS + t.
template <int DC, int NC>
__global__ void __launch_bounds__(THREADS, DC == 16 ? 4 : 1)
sweep_kernel(const float* __restrict__ x, const float* __restrict__ xs,
             const float* __restrict__ b2s, const int32_t* __restrict__ ends,
             const int32_t* __restrict__ ids, float* __restrict__ sums, int n,
             int d, int np, int k, int tiles_per_split, int64_t stride_k,
             int64_t stride_i) {
  __shared__ __align__(16) float xj_s[2][TN * DC];
  __shared__ __align__(16) float b2_s[2][TN];
  __shared__ __align__(16) int32_t end_s[2][TN];
  __shared__ __align__(16) int32_t id_s[2][TN * NC];
  __shared__ float dv_s[8 * R * THREADS];  // walked groups, column tid

  const int tid = threadIdx.x;
  const int q_count = (d + DC - 1) / DC;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, np / TN);
  const int stages = (t1 - t0) * q_count;
  if (stages <= 0) return;  // the whole block: no barrier is skipped

  int row[R];
  bool row_ok[R];
  float a2[R];  // the same fmaf chain as prepare_kernel's b2
  float* prow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = blockIdx.x * TM + r * THREADS + tid;
    row_ok[r] = row[r] < n;
    a2[r] = 0.0f;
    for (int f = 0; row_ok[r] && f < d; ++f) {
      const float v = x[(size_t)row[r] * d + f];
      a2[r] = fmaf(v, v, a2[r]);
    }
    prow[r] = sums + (size_t)blockIdx.y * k * n + row[r] * stride_i;
  }

  // stage s: tile t0 + s / q_count, feature chunk s % q_count
  auto issue = [&](int s) {
    const int b = s & 1;
    const int t = t0 + s / q_count, q = s % q_count;
    const float* gx = xs + ((size_t)q * np + (size_t)t * TN) * DC;
    constexpr int NX = TN * DC / 4, NB = TN / 4, NI = TN * NC / 4;
    for (int c = tid; c < NX + 2 * NB + NI; c += THREADS) {
      if (c < NX)
        cp_async16(&xj_s[b][4 * c], gx + 4 * c);
      else if (c < NX + NB)
        cp_async16(&b2_s[b][4 * (c - NX)],
                   b2s + (size_t)t * TN + 4 * (c - NX));
      else if (c < NX + 2 * NB)
        cp_async16(&end_s[b][4 * (c - NX - NB)],
                   ends + (size_t)t * TN + 4 * (c - NX - NB));
      else
        cp_async16(&id_s[b][4 * (c - NX - 2 * NB)],
                   ids + (size_t)t * TN * NC + 4 * (c - NX - 2 * NB));
    }
    cp_async_commit();
  };

  float xi[R][DC];
  float cr[R][TN];  // cross products, then distances
  float acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;

  issue(0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages)
      issue(s + 1);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
    const int b = s & 1;
    const int q = s % q_count;
    if (q_count > 1 || s == 0) {  // the rows' features of chunk q
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int f = q * DC + c;
          xi[r][c] = row_ok[r] && f < d ? x[(size_t)row[r] * d + f] : 0.0f;
        }
    }
    cp_async_wait_one();
    __syncthreads();  // stage s has landed for every thread

    if (q == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < TN; ++u) cr[r][u] = 0.0f;
    }
    // one broadcast load of 4 features of a cell feeds 4 * R FMAs
    const float4* xj = reinterpret_cast<const float4*>(xj_s[b]);
#pragma unroll
    for (int u = 0; u < TN; ++u) {
#pragma unroll
      for (int c4 = 0; c4 < DC / 4; ++c4) {
        const float4 v = xj[u * (DC / 4) + c4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          cr[r][u] = fmaf(xi[r][4 * c4 + 0], v.x, cr[r][u]);
          cr[r][u] = fmaf(xi[r][4 * c4 + 1], v.y, cr[r][u]);
          cr[r][u] = fmaf(xi[r][4 * c4 + 2], v.z, cr[r][u]);
          cr[r][u] = fmaf(xi[r][4 * c4 + 3], v.w, cr[r][u]);
        }
      }
    }

    if (q == q_count - 1) {
      // where each cut's runs end in this tile: the same 32 bits in every
      // thread, so every branch on them below is uniform
      const int em = end_s[b][tid % 32];
      unsigned tmask[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tmask[c] = __ballot_sync(FULL, (em >> c) & 1);
      // the tile's distances, with no branch, then sums of 8 cells
      const float4* b2v = reinterpret_cast<const float4*>(b2_s[b]);
      float s8[R][TN / 8];
#pragma unroll
      for (int u4 = 0; u4 < TN / 4; ++u4) {
        const float4 bv = b2v[u4];
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = 4 * u4 + e;
            cr[r][u] = sqrt_approx(
                fmaxf(a2[r] + bb[e] - 2.0f * cr[r][u], 0.0f));
          }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < TN / 8; ++g) {
          const float* v = &cr[r][8 * g];
          s8[r][g] = ((v[0] + v[1]) + (v[2] + v[3])) +
                     ((v[4] + v[5]) + (v[6] + v[7]));
        }
      // into the run sums. A tile, or a group of 8 cells, with no run end
      // in any cut adds its sum to every cut's run sum. A group with one
      // (rare in cluster order) puts its distances in this thread's column
      // of shared memory, and each cut with an end there walks it cell by
      // cell, writing each run that ends
      unsigned tile_any = 0;
#pragma unroll
      for (int c = 0; c < NC; ++c) tile_any |= tmask[c];
#pragma unroll
      for (int g = 0; g < TN / 8; ++g) {
        if (tile_any == 0) {
          if (g == 0) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float t = (s8[r][0] + s8[r][1]) + (s8[r][2] + s8[r][3]);
#pragma unroll
              for (int c = 0; c < NC; ++c) acc[r][c] += t;
            }
          }
          continue;
        }
        unsigned any = 0;
#pragma unroll
        for (int c = 0; c < NC; ++c) any |= tmask[c] >> (8 * g);
        if ((any & 0xffu) == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[r][c] += s8[r][g];
          continue;
        }
#pragma unroll
        for (int w = 0; w < 8; ++w)
#pragma unroll
          for (int r = 0; r < R; ++r)
            dv_s[(w * R + r) * THREADS + tid] = cr[r][8 * g + w];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const unsigned m = (tmask[c] >> (8 * g)) & 0xffu;
          if (m == 0) {
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r][c] += s8[r][g];
            continue;
          }
#pragma unroll 1
          for (int w = 0; w < 8; ++w) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[r][c] += dv_s[(w * R + r) * THREADS + tid];
            if ((m >> w) & 1u) {
              const int gid = id_s[b][(8 * g + w) * NC + c];
#pragma unroll
              for (int r = 0; r < R; ++r) {
                if (row_ok[r] && gid >= 0 && gid < k)
                  add_to(prow[r] + gid * stride_k, acc[r][c]);
                acc[r][c] = 0.0f;
              }
            }
          }
        }
      }
    }
    __syncthreads();  // buffer b is read; stage s + 2 may overwrite it
  }

  // runs still open at the end of this range of cells: the next range
  // adds the rest into its own partial sums
  const int32_t* last = ids + ((size_t)t1 * TN - 1) * NC;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int gid = last[c];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (row_ok[r] && gid >= 0 && gid < k)
        add_to(prow[r] + gid * stride_k, acc[r][c]);
  }
}

// S[i, kk] = sum over splits s, in order, of part[s][kk][i]: a 32 x 32
// tile through shared memory, read along i and written along k.
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int n,
              int k, int splits) {
  __shared__ float tile[32][33];
  const int i0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    const int kk = k0 + r, i = i0 + tx;
    float v = 0.0f;
    if (kk < k && i < n)
      for (int s = 0; s < splits; ++s) v += part[((size_t)s * k + kk) * n + i];
    tile[r][tx] = v;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int i = i0 + r, kk = k0 + tx;
    if (i < n && kk < k) out[(size_t)i * k + kk] = tile[tx][r];
  }
}

__device__ __forceinline__ int valid_id(int g, int k) {
  return g >= 0 && g < k ? g : -1;
}

// keys[j] = the ids of cuts g0 .. g0 + cg - 1 of cell j, each outside
// [0, K) taken as -1, as one number in base K + 2 (cut g0 most
// significant): sorting the keys sorts the cells by cut g0, then g0 + 1...
__global__ void keys_kernel(const int32_t* __restrict__ labels,
                            int64_t* __restrict__ keys, int n, int c, int g0,
                            int cg, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int64_t key = 0;
  for (int cc = 0; cc < cg; ++cc)
    key = key * (k + 2) + valid_id(labels[(size_t)j * c + g0 + cc], k) + 1;
  keys[j] = key;
}

// Slot j of the cluster order (np slots, the last np - n empty): the
// features of cell order[j] padded to Q chunks of DC, their norm, its ids
// padded to NC cuts with -1, and the mask of the cuts whose run ends here;
// and the first sums_len sums set to zero.
__global__ void prepare_kernel(const float* __restrict__ x,
                               const int32_t* __restrict__ labels,
                               const int64_t* __restrict__ order,
                               float* __restrict__ xs, float* __restrict__ b2s,
                               int32_t* __restrict__ ids,
                               int32_t* __restrict__ ends,
                               float* __restrict__ sums, int64_t sums_len,
                               int n, int d, int c, int g0, int cg, int nc,
                               int k, int np, int dc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t z = j; z < sums_len; z += (int64_t)gridDim.x * blockDim.x)
    sums[z] = 0.0f;
  if (j >= np) return;
  const int64_t src = j >= n ? -1 : order ? order[j] : j;
  const int64_t nxt = j + 1 >= n ? -1 : order ? order[j + 1] : j + 1;
  const int q_count = (d + dc - 1) / dc;
  float b2 = 0.0f;
  for (int f = 0; f < q_count * dc; ++f) {
    const float v = src >= 0 && f < d ? x[src * d + f] : 0.0f;
    xs[((size_t)(f / dc) * np + j) * dc + f % dc] = v;
    if (f < d) b2 = fmaf(v, v, b2);
  }
  b2s[j] = b2;
  int mask = 0;
  for (int cc = 0; cc < nc; ++cc) {
    const int g = src >= 0 && cc < cg
                      ? valid_id(labels[src * c + g0 + cc], k) : -1;
    ids[(size_t)j * nc + cc] = g;
    if (src >= 0 && cc < cg &&
        (nxt < 0 || valid_id(labels[nxt * c + g0 + cc], k) != g))
      mask |= 1 << cc;
  }
  ends[j] = mask;
}

using SweepFn = void (*)(const float*, const float*, const float*,
                        const int32_t*, const int32_t*, float*, int, int, int,
                        int, int, int64_t, int64_t);

// the sweep built for features d and nc padded cuts, or null
template <int DC>
SweepFn sweep_with(int64_t nc) {
  switch (nc) {
    case 1: return sweep_kernel<DC, 1>;
    case 2: return sweep_kernel<DC, 2>;
    case 4: return sweep_kernel<DC, 4>;
    default: return nullptr;
  }
}
SweepFn sweep_for(int64_t d, int64_t nc) {
  return d <= 16 ? sweep_with<16>(nc) : sweep_with<32>(nc);
}

}  // namespace

extern "C" {

// How many sweep blocks an SM holds at once for features d and nc cuts
// (the occupancy calculator's answer), in *blocks.
int scc_dcs_blocks_per_sm(int64_t d, int64_t nc, int* blocks) {
  const SweepFn fn = sweep_for(d, nc);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS, 0));
}

// keys (n,) int64 of cuts g0 .. g0 + cg - 1 of labels (n, c) int32, for a
// stable sort into cluster order; (k + 2)^cg must stay below 2^63.
int scc_dcs_keys(const int32_t* labels, int64_t* keys, int64_t n, int64_t c,
                 int64_t g0, int64_t cg, int64_t k, void* stream) {
  if (n < 1 || c < 1 || cg < 1 || g0 < 0 || g0 + cg > c || k < 1 ||
      n > INT32_MAX || c > INT32_MAX || k > INT32_MAX - 2)
    return static_cast<int>(cudaErrorInvalidValue);
  keys_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      labels, keys, (int)n, (int)c, (int)g0, (int)cg, (int)k);
  return static_cast<int>(cudaGetLastError());
}

// One group of cuts g0 .. g0 + cg - 1 (cg <= nc, nc in {1, 2, 4}) in the
// cluster order `order` (n,) int64, or the caller's order when it is null.
// Lays the ordered cells out in the scratch buffers xs (ceil(d / dc), np,
// dc) with dc = 16 if d <= 16 else 32, b2 (np,), ids (np, nc) and ends
// (np,), np a multiple of 32 and at least n, and adds the group's run sums
// into the sums: with one split straight into out (n, k); with more into
// part (splits, k, n), from which `last` writes out. `first` zeroes the
// sums first. x (n, d) fp32 and labels (n, c) int32 in the caller's order.
// All contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for sizes
// the kernels do not take.
int scc_dcs_group(const float* x, const int32_t* labels, const int64_t* order,
                  float* xs, float* b2, int32_t* ids, int32_t* ends,
                  float* part, float* out, int64_t n, int64_t d, int64_t c,
                  int64_t g0, int64_t cg, int64_t nc, int64_t k, int64_t np,
                  int64_t tiles_per_split, int64_t splits, int64_t first,
                  int64_t last, void* stream) {
  if (n < 1 || d < 1 || k < 1 || c < 1 || cg < 1 || cg > nc || g0 < 0 ||
      g0 + cg > c || np < n || np % TN != 0 || tiles_per_split < 1 ||
      splits < 1 || splits > 65535 || np > INT32_MAX || d > INT32_MAX ||
      c > INT32_MAX || k > INT32_MAX || (k + 31) / 32 > 65535 ||
      (splits > 1 && part == nullptr) || sweep_for(d, nc) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int ni = (int)n, di = (int)d, npi = (int)np, ki = (int)k,
      tps = (int)tiles_per_split;
  const int dc = d <= 16 ? 16 : 32;
  float* sums = splits == 1 ? out : part;
  prepare_kernel<<<static_cast<unsigned>((np + 127) / 128), 128, 0, st>>>(
      x, labels, order, xs, b2, ids, ends, sums, first ? splits * k * n : 0,
      ni, di, (int)c, (int)g0, (int)cg, (int)nc, ki, npi, dc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // one split: straight into S (n, k); else into part (splits, k, n)
  int64_t stride_k = splits == 1 ? 1 : n, stride_i = splits == 1 ? k : 1;
  const float* xc = xs;
  const float* bc = b2;
  const int32_t* ec = ends;
  const int32_t* ic = ids;
  void* args[] = {&x,  &xc, &bc, &ec, &ic,  &sums,     &ni,
                  &di, &npi, &ki, &tps, &stride_k, &stride_i};
  err = cudaLaunchKernel(
      reinterpret_cast<const void*>(sweep_for(d, nc)),
      dim3(static_cast<unsigned>((n + TM - 1) / TM),
           static_cast<unsigned>(splits)),
      dim3(THREADS), args, 0, st);
  if (err != cudaSuccess || !last || splits == 1) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + 31) / 32),
                  static_cast<unsigned>((k + 31) / 32));
  reduce_kernel<<<grid, 256, 0, st>>>(part, out, ni, ki, (int)splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
