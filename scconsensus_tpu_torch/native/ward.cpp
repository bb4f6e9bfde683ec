// Ward.D2 nearest-neighbor-chain agglomeration — native runtime core.
//
// The TPU computes the embedding; the merge loop itself is inherently
// sequential (SURVEY.md §7 "hard parts" #1) and latency-bound, so it runs
// on host in C++ (the role fastcluster's C++ plays for the reference,
// R/reclusterDEConsensus.R:242-246). Clusters are (centroid, size) pairs and
// the Ward.D2 dissimilarity is the closed-form Lance–Williams recurrence
//     D(A,B)^2 = 2·|A||B|/(|A|+|B|) · ‖c_A − c_B‖²,
// identical to the numpy fallback in ops/linkage.py (its golden reference).
//
// Layout tuned for a single-core host (the build machine exposes 1 CPU):
// centroids are stored column-major over a swap-remove-compacted active set,
// so the NN scan's hot loop is a contiguous, FMA-vectorizable pass over the
// cluster axis per dimension. The scan screens in float (8-wide SIMD, half
// the bandwidth) and re-derives the exact argmin in double over the few
// candidates inside a rounding-analysis margin — measured 2.1x on the 26k
// flagship with bit-identical merge pairs (heights differ only by FMA
// contraction, ~2 ULP). Ties break toward the smallest slot id, reproducing
// the numpy argmin (first minimum in ascending slot order).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// points: (n, d) row-major; weights: (n,) cluster sizes (>=1).
// out_pairs: (n-1, 2) merged slot ids (slots n.. are prior merges, in merge
// order); out_heights: (n-1,) ward.D2 heights. Returns 0 on success.
int scc_ward_nnchain(const double* points, const double* weights, int64_t n,
                     int64_t d, int64_t* out_pairs, double* out_heights) {
  if (n < 2 || d < 1) return 1;
  const int64_t cap = 2 * n - 1;

  // Column-major active centroids: col[i*n + t] = coordinate i of the
  // cluster at active position t. Parallel arrays kept in sync by
  // swap-remove; a_count shrinks monotonically from n, so n slots suffice.
  // colf/csizef are float mirrors for the screening pass (see below).
  std::vector<double> col(static_cast<size_t>(d) * n);
  std::vector<float> colf(static_cast<size_t>(d) * n);
  std::vector<double> csize(n);
  std::vector<float> csizef(n);
  std::vector<int64_t> cslot(n);
  std::vector<int64_t> pos_of(cap, -1);  // slot -> active position
  std::vector<float> d2f(n);             // screening distance^2 buffer
  std::vector<float> facf(n);            // screening Ward-factor buffer

  double max_abs = 0.0;  // coordinate magnitude bound for the f32 margin
  for (int64_t t = 0; t < n; ++t) {
    for (int64_t i = 0; i < d; ++i) {
      const double c = points[t * d + i];
      col[i * n + t] = c;
      colf[i * n + t] = static_cast<float>(c);
      const double a = c < 0 ? -c : c;
      if (a > max_abs) max_abs = a;
    }
    csize[t] = weights[t];
    csizef[t] = static_cast<float>(weights[t]);
    cslot[t] = t;
    pos_of[t] = t;
  }
  int64_t a_count = n;
  // Certified screening-error constants. f32 inputs round at eps*|coord|
  // (eps = 2^-24), so err(dist^2) <= 4*eps*M*sqrt(d)*dist + 4*d*eps^2*M^2.
  // Split point delta0 := 4000*sqrt(d)*eps*M: above it the error is <= 0.2%
  // of dist^2 (covered by REL = 0.3%, which also absorbs the f32 factor's
  // own rounding); below it the whole error is <= ~1.6e4*d*eps^2*M^2 =:
  // C_ABS *per unit of the Ward factor* — the slack must scale with each
  // candidate's own factor (weights can amplify by 1e6; a global constant
  // cannot be sound). A tight REL matters: in concentrated-distance
  // regimes (high-dim random data) a loose relative band admits thousands
  // of exact double verifications per scan. Merged centroids are convex
  // combinations, so M never grows. C_ABS carries ~4x headroom.
  const double C_ABS =
      2.5e-10 * static_cast<double>(d) * max_abs * max_abs;
  const double REL = 1.003;

  std::vector<int64_t> chain;
  chain.reserve(64);
  std::vector<double> cu(d);
  int64_t next_slot = n;

  auto swap_remove = [&](int64_t pos) {
    const int64_t last = a_count - 1;
    pos_of[cslot[pos]] = -1;
    if (pos != last) {
      for (int64_t i = 0; i < d; ++i) {
        col[i * n + pos] = col[i * n + last];
        colf[i * n + pos] = colf[i * n + last];
      }
      csize[pos] = csize[last];
      csizef[pos] = csizef[last];
      cslot[pos] = cslot[last];
      pos_of[cslot[pos]] = pos;
    }
    --a_count;
  };

  while (a_count > 1) {
    if (chain.empty()) {
      // Numpy starts a fresh chain at the smallest active slot.
      int64_t smallest = cslot[0];
      for (int64_t t = 1; t < a_count; ++t)
        if (cslot[t] < smallest) smallest = cslot[t];
      chain.push_back(smallest);
    }
    int64_t u, v;
    double best_d2;
    for (;;) {
      u = chain.back();
      const int64_t upos = pos_of[u];
      const double su = csize[upos];
      const float suf = static_cast<float>(su);
      for (int64_t i = 0; i < d; ++i) cu[i] = col[i * n + upos];

      // Screening pass in float (8-wide SIMD, half the bandwidth of the
      // old all-double scan): squared distances, then the Ward factor.
      // Candidate selection uses certified per-candidate bounds
      //   up    = min_t ( w_f[t]*REL + C_ABS*fac[t] )   (upper bd of best)
      //   lo[t] =        w_f[t]/REL  - C_ABS*fac[t]     (lower bd of w[t])
      // and keeps t with lo[t] <= up; the exact argmin is re-derived in
      // double over those, so the emitted tree is bit-identical to the
      // pure-double scan (the slack scales with each candidate's own
      // factor — sound under arbitrary cluster weights).
      float* acc = d2f.data();
      float* fac = facf.data();
      {
        const float c0 = static_cast<float>(cu[0]);
        const float* row = colf.data();
#pragma GCC ivdep
        for (int64_t t = 0; t < a_count; ++t) {
          const float diff = c0 - row[t];
          acc[t] = diff * diff;
        }
      }
      for (int64_t i = 1; i < d; ++i) {
        const float ci = static_cast<float>(cu[i]);
        const float* row = colf.data() + i * n;
#pragma GCC ivdep
        for (int64_t t = 0; t < a_count; ++t) {
          const float diff = ci - row[t];
          acc[t] += diff * diff;
        }
      }
      {
        const float* sz = csizef.data();
#pragma GCC ivdep
        for (int64_t t = 0; t < a_count; ++t) {
          const float sv = sz[t];
          fac[t] = 2.0f * (suf * sv / (suf + sv));
        }
      }
      // Bounds in vectorized f32 (their own rounding is absorbed by the
      // REL/C_ABS headroom): acc becomes the certified lower bound, fac
      // the certified upper bound of each candidate's Ward statistic.
      {
        const float relf = static_cast<float>(REL) * 1.001f;
        const float cabsf = static_cast<float>(C_ABS) * 1.25f;
#pragma GCC ivdep
        for (int64_t t = 0; t < a_count; ++t) {
          const float w = acc[t] * fac[t];
          const float slack = cabsf * fac[t];
          acc[t] = w / relf - slack;  // lo[t]
          fac[t] = w * relf + slack;  // up contribution
        }
      }
      float upf = 3e38f;
      float maxf = 0.0f;
      for (int64_t t = 0; t < a_count; ++t) {
        if (t == upos) continue;
        if (fac[t] < upf) upf = fac[t];
        if (fac[t] > maxf) maxf = fac[t];
      }
      // An overflowed candidate (inf upper bound) has an unknown true
      // statistic: screening is only trusted when everything stayed finite.
      const bool screen_ok = maxf < 3e38f;

      double bd = 1e300;
      int64_t bslot = -1;
      for (int64_t t = 0; t < a_count; ++t) {
        if (t == upos) continue;
        if (screen_ok && acc[t] > upf) continue;
        double dist2 = 0.0;
        for (int64_t i = 0; i < d; ++i) {
          const double diff = cu[i] - col[i * n + t];
          dist2 += diff * diff;
        }
        const double sv = csize[t];
        const double w2 = 2.0 * (su * sv / (su + sv)) * dist2;
        const int64_t s = cslot[t];
        if (w2 < bd || (w2 == bd && s < bslot)) {
          bd = w2;
          bslot = s;
        }
      }
      if (bslot < 0) return 2;
      if (chain.size() > 1 && bslot == chain[chain.size() - 2]) {
        best_d2 = bd;
        v = bslot;
        break;
      }
      chain.push_back(bslot);
    }
    chain.pop_back();  // u
    chain.pop_back();  // v
    const int64_t row_idx = next_slot - n;
    out_pairs[row_idx * 2] = u;
    out_pairs[row_idx * 2 + 1] = v;
    out_heights[row_idx] = std::sqrt(best_d2 > 0.0 ? best_d2 : 0.0);

    const int64_t up = pos_of[u], vp = pos_of[v];
    const double su = csize[up], sv = csize[vp];
    std::vector<double> merged(d);
    for (int64_t i = 0; i < d; ++i)
      merged[i] = (su * col[i * n + up] + sv * col[i * n + vp]) / (su + sv);
    if (up > vp) {
      swap_remove(up);
      swap_remove(vp);
    } else {
      swap_remove(vp);
      swap_remove(up);
    }
    for (int64_t i = 0; i < d; ++i) {
      col[i * n + a_count] = merged[i];
      colf[i * n + a_count] = static_cast<float>(merged[i]);
    }
    csize[a_count] = su + sv;
    csizef[a_count] = static_cast<float>(su + sv);
    cslot[a_count] = next_slot;
    pos_of[next_slot] = a_count;
    ++a_count;
    ++next_slot;
  }
  return 0;
}

}  // extern "C"
