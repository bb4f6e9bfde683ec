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
// entries), so here the kernel takes the C cluster ids themselves and adds
// each distance to its C clusters: C adds per pair instead of 2K.
//
// What bounds it on this card: operations. The work is N^2 * (2d + 3)
// fp32 operations for the distances plus N^2 * C adds into clusters
// (2.5e10 at N = 26,000, d = 15, C = 4), against N * (d + C + K) * 4 bytes
// (49 MB at K = 449) read and written once, so the floor is the fp32
// CUDA-core rate, not device memory. In practice step 3 below is what
// the kernel waits on: each add reads a sum from shared memory before it
// can write it, and the sums (K * TM * 4 bytes a block) cap how many
// blocks share an SM (3 at K = 449).
//
// What the design does about it: nothing of the sweep leaves the SM. One
// block owns TM = 32 rows of i and a slice of up to TK clusters, and keeps
// the (TK x TM) sums in shared memory for the whole sweep over j. x_i and
// its norms are staged once per block. A loop over j tiles of TN = 64
// cells takes the place of the Pallas grid's sequential j axis:
//   1. Half the threads stage x_j (feature-major) and its norms, the
//      other half the tile's cluster ids, in shared memory.
//   2. Each thread computes a 4 x 4 patch of the (TM x TN) distance tile,
//      same formula as the reference, from float4 loads of x_i and x_j
//      (8 loads feed 16 FMAs per feature), into shared memory, row-major.
//   3. Warp w adds the tile into the sums of cuts w, w + 4, ...: lane r
//      owns row r, the cluster id of cell j is the same for the whole warp
//      (held in registers, passed by shuffles), so each add is one
//      conflict-free read and write of 32 consecutive sums, and warps of
//      different cuts touch disjoint sums. A read-add-write waits for its
//      read, so the warp takes four cells at once: four reads in flight.
//      Groups in which two cells share a cluster (a ballot per tile finds
//      them) add one cell after another.
// Every sum is written by one thread in a fixed order, so there are no
// atomics and the result is the same from run to run. Ragged rows, cells,
// clusters and features are masked here; the host pads nothing. fp32 FMA
// on the CUDA cores throughout: no TF32, no bf16.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;          // rows of i per block: one per lane
constexpr int TN = 64;          // cells of j per tile
constexpr int TK_MAX = 512;     // clusters per block
constexpr int THREADS = 128;    // 4 warps
constexpr int XJ = TN + 4;      // x_j and distance row strides: float4-
                                // aligned, conflict-free float4 access
constexpr int AC = TM + 1;      // sums row stride: conflict-free write-out
constexpr int SMEM_MAX = 232448;
static_assert(TM == 32 && TN == 64 && THREADS == 2 * TN,
              "lane = row; a warp holds a tile's ids in two registers; "
              "one staging thread per cell for x_j and one for the ids");

// Shared memory, in floats: xi (d x TM), a2 (TM), xj (d x XJ), b2 (TN),
// dist (TM x XJ), ids (C x TN, int), the sums (tk x AC).
__host__ __device__ inline int64_t smem_floats(int d, int c, int tk) {
  return (int64_t)d * TM + TM + (int64_t)d * XJ + TN + TM * XJ +
         (int64_t)c * TN + (int64_t)tk * AC;
}

__global__ void __launch_bounds__(THREADS)
distance_cluster_sums_kernel(const float* __restrict__ x,
                             const int32_t* __restrict__ labels,
                             float* __restrict__ out, int n, int d, int nc,
                             int k, int tk_max) {
  extern __shared__ __align__(16) float smem[];
  float* xi_s = smem;                   // [d][TM]
  float* a2_s = xi_s + d * TM;          // [TM]
  float* xj_s = a2_s + TM;              // [d][XJ]
  float* b2_s = xj_s + d * XJ;          // [TN]
  float* dist_s = b2_s + TN;            // [TM][XJ]
  int* lab_s = reinterpret_cast<int*>(dist_s + TM * XJ);        // [nc][TN]
  float* acc_s = reinterpret_cast<float*>(lab_s + nc * TN);      // [tk][AC]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i0 = blockIdx.x * TM;
  const int k0 = blockIdx.y * tk_max;
  const int tk = min(tk_max, k - k0);

  // x_i and its norms, once per block; the sums start at zero
  if (tid < TM) {
    const int gi = i0 + tid;
    float a2 = 0.0f;
    for (int c = 0; c < d; ++c) {
      const float v = gi < n ? x[(int64_t)gi * d + c] : 0.0f;
      xi_s[c * TM + tid] = v;
      a2 = fmaf(v, v, a2);
    }
    a2_s[tid] = a2;
  }
  for (int idx = tid; idx < tk * AC; idx += THREADS) acc_s[idx] = 0.0f;

  // distance phase: thread owns rows 4*ty .. 4*ty+3, cells 4*tx .. 4*tx+3
  const int ty = tid % 8;
  const int tx = tid / 8;

  for (int j0 = 0; j0 < n; j0 += TN) {
    __syncthreads();  // the last tile's readers are done
    if (tid < TN) {   // x_j and its norms, transposed
      const int gj = j0 + tid;
      const float* xr = x + (int64_t)gj * d;
      float b2 = 0.0f;
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        const float v = gj < n ? xr[c] : 0.0f;
        xj_s[c * XJ + tid] = v;
        b2 = fmaf(v, v, b2);
      }
      b2_s[tid] = b2;
    } else {          // the tile's cluster ids
      const int jj = tid - TN;
      const int32_t* lr = labels + (int64_t)(j0 + jj) * nc;
      for (int c = 0; c < nc; ++c)
        lab_s[c * TN + jj] = j0 + jj < n ? lr[c] : -1;
    }
    __syncthreads();  // the tile is in place
    const float* xj = xj_s;
    const int* lab = lab_s;

    float cr[4][4], b2[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      b2[a] = b2_s[4 * tx + a];
#pragma unroll
      for (int b = 0; b < 4; ++b) cr[a][b] = 0.0f;
    }
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float4 av = *reinterpret_cast<const float4*>(&xi_s[c * TM + 4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&xj[c * XJ + 4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int a = 0; a < 4; ++a) cr[a][b] = fmaf(ar[a], br[b], cr[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float a2 = a2_s[4 * ty + a];
      float dv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        dv[b] = sqrtf(fmaxf(a2 + b2[b] - 2.0f * cr[a][b], 0.0f));
      *reinterpret_cast<float4*>(&dist_s[(4 * ty + a) * XJ + 4 * tx]) =
          make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
    __syncthreads();  // the distance tile is in place

    // cluster phase: warp w adds into the sums of cuts w, w + 4, ...,
    // four cells at a time. The four sums are read together, so four reads
    // are in flight instead of one, and written back; a group in which two
    // cells share a cluster (found once per tile by a ballot) is added one
    // cell after another instead.
    float* acc_r = acc_s + lane;
    const float* dist_r = dist_s + lane * XJ;
    for (int c = warp; c < nc; c += THREADS / 32) {
      int ids[2];
      unsigned shared[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jj = 32 * h + lane;
        const int g = lab[c * TN + jj];
        // outside the slice: a negative id of the cell's own, so that it
        // shares a cluster with no other cell
        ids[h] = (j0 + jj < n && g >= k0 && g < k0 + tk) ? g - k0 : -1 - jj;
        bool dup = false;
#pragma unroll
        for (int m = 1; m < 4; ++m)
          dup |= __shfl_xor_sync(0xffffffffu, ids[h], m) == ids[h];
        shared[h] = __ballot_sync(0xffffffffu, dup);
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const int h = q / 8, base = 4 * (q % 8);
        int l[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          l[g] = __shfl_sync(0xffffffffu, ids[h], base + g);
        const float4 d4 = *reinterpret_cast<const float4*>(&dist_r[4 * q]);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
        if (((shared[h] >> base) & 0xFu) == 0) {
          float v[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) v[g] = l[g] >= 0 ? acc_r[l[g] * AC] : 0.0f;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            if (l[g] >= 0) acc_r[l[g] * AC] = v[g] + dv[g];
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            if (l[g] >= 0) acc_r[l[g] * AC] += dv[g];
        }
      }
    }
  }
  __syncthreads();  // every sum is final

  for (int idx = tid; idx < TM * tk; idx += THREADS) {
    const int r = idx / tk, kk = idx % tk;
    const int gi = i0 + r;
    if (gi < n) out[(int64_t)gi * k + k0 + kk] = acc_s[kk * AC + r];
  }
}

}  // namespace

extern "C" {

// x (n, d) fp32, labels (n, nc) int32, out (n, k) fp32: contiguous, on the
// device. Launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for sizes the kernel does not take
// (d so wide that x_i and x_j tiles leave no shared memory for the sums).
int scc_distance_cluster_sums(const float* x, const int32_t* labels,
                              float* out, int64_t n, int64_t d, int64_t nc,
                              int64_t k, void* stream) {
  if (n < 1 || d < 1 || nc < 1 || k < 1 || n > INT32_MAX || d > INT32_MAX ||
      nc > INT32_MAX || k > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // the widest cluster slice that fits beside the tiles
  int64_t tk = k < TK_MAX ? k : TK_MAX;
  while (tk > 0 && smem_floats((int)d, (int)nc, (int)tk) * 4 > SMEM_MAX)
    tk -= 32;
  if (tk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_floats((int)d, (int)nc,
                                                      (int)tk)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      distance_cluster_sums_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + TM - 1) / TM),
                  static_cast<unsigned>((k + tk - 1) / tk));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  distance_cluster_sums_kernel<<<grid, THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, labels, out, static_cast<int>(n), static_cast<int>(d),
      static_cast<int>(nc), static_cast<int>(k), static_cast<int>(tk));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
