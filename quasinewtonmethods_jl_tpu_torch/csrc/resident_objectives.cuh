// The objectives the resident solver B3 (resident_solve.cu) evaluates on
// the card. The JAX kernel traces any jnp objective into its body, closed
// over data arrays that it hoists into kernel inputs
// (quasinewtonmethods_jl_tpu/resident_solve.py :: _hoist_consts); a kernel
// written by hand takes its objective as a template argument instead, one
// instantiation each, with its data in device memory.
//
// An objective supplies, for one lane run by a lane group (bfgs_common.cuh):
//   kOwned, owned(n)     the vector entries a thread owns: X, G, G_old, STEP
//                        and d of those entries live in its registers;
//   value_and_grad(...)  the gradient of the owned entries at X, and the
//                        thread's share of the value in two terms (`terms`,
//                        `extra`) that the solver's first lane sum totals;
//   value(terms, extra)  the value from those totals;
//   value_along(alpha)   the value at X + alpha·d (a line-search trial): a
//                        fresh evaluation, with a lane sum of its own;
//   extra_values(n)      the shared memory it needs beyond the solver's, in
//                        values (host side).
// Each evaluates in the plain versions' order of operations (the
// models/*.py expressions, term for term); only the order of the sums
// differs. Lane sums also publish the shared writes made before them, and
// every objective's reads of shared memory end before its last lane sum,
// so the next evaluation may write that memory at once.

#pragma once

#include "bfgs_common.cuh"

namespace qnm {

template <int K>
struct Owned {
  int idx[K];  // clamped to a real entry, so that a thread without one reads valid memory
  bool has[K];
};

// The update's own column ownership (`Columns`): thread t owns entries t
// and t + blockDim.x.
__device__ __forceinline__ Owned<2> owned_columns(int n) {
  const Columns cols(n);
  Owned<2> o;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    o.idx[c] = cols.j[c];
    o.has[c] = cols.own[c];
  }
  return o;
}

__device__ __forceinline__ float exp_of(float v) { return expf(v); }
__device__ __forceinline__ double exp_of(double v) { return exp(v); }
__device__ __forceinline__ float log1p_of(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_of(double v) { return log1p(v); }

// models/rosenbrock.py: -Σ 100 r² + (1 - a)², r = b - a², over the pairs
// (a, b) = (x[i], x[half + i]), and -(1 - x[n-1])² for odd n. A thread owns
// the pair i = threadIdx.x < n/2, and thread 0 also the odd-n tail (n/2
// never exceeds the lane's threads, so a thread owns at most one pair).
// No data; the top of an iteration computes rosenbrock_value_and_grad's
// expressions, a trial rosenbrock_logdensity's.
template <typename T>
struct RosenbrockObjective {
  static constexpr int kOwned = 3;
  static size_t extra_values(int) { return 0; }

  __device__ __forceinline__ Owned<3> owned(int n) const {
    const int half = n >> 1;
    const int t = threadIdx.x;
    Owned<3> o;
    o.has[0] = o.has[1] = t < half;
    o.idx[0] = t;
    o.idx[1] = half + t;
    o.has[2] = (n & 1) && t == 0;
    o.idx[2] = n - 1;
    return o;
  }

  // terms: the pair's 100 r² + (1 - a)²; extra: the tail's square (only
  // thread 0 adds it, so its sum is exact)
  template <bool kOneWarp>
  __device__ __forceinline__ void value_and_grad(LaneGroup<T, kOneWarp>&, const Owned<3>& own,
                                                 int, T*, const T (&x)[3], T (&g)[3], T& terms,
                                                 T& extra) const {
    if (own.has[0]) {
      const T a = x[0];
      const T r = x[1] - a * a;
      const T oma = T(1) - a;
      terms = T(100) * r * r + oma * oma;
      g[0] = T(400) * r * a + T(2) * oma;
      g[1] = T(-200) * r;
    }
    if (own.has[2]) {
      const T delta = T(1) - x[2];
      extra = delta * delta;
      g[2] = T(2) * delta;
    }
  }

  __device__ __forceinline__ T value(T terms, T extra, int n) const {
    T f = -terms;
    if (n & 1) f = f - extra;
    return f;
  }

  template <bool kOneWarp>
  __device__ __forceinline__ T value_along(LaneGroup<T, kOneWarp>& grp, const Owned<3>& own,
                                           int n, T*, const T (&x)[3], const T (&d)[3],
                                           T alpha) const {
    T v[2] = {T(0), T(0)};  // the pairs' terms, the tail's
    if (own.has[0]) {
      const T a = x[0] + alpha * d[0];
      const T r = (x[1] + alpha * d[1]) - a * a;
      const T oma = T(1) - a;
      v[0] = T(100) * (r * r) + oma * oma;
    }
    if (own.has[2]) {
      const T delta = T(1) - (x[2] + alpha * d[2]);
      v[1] = delta * delta;
    }
    grp.sum(v);
    return value(v[0], v[1], n);
  }
};

// models/quadratic.py: -(1/2) Σ diag·(x - x*)², gradient -diag·(x - x*),
// with diag and x* (n each) read from device memory by the entries' owners.
template <typename T>
struct QuadraticObjective {
  const T* __restrict__ diag;
  const T* __restrict__ x_star;

  static constexpr int kOwned = 2;
  static size_t extra_values(int) { return 0; }

  __device__ __forceinline__ Owned<2> owned(int n) const { return owned_columns(n); }

  template <bool kOneWarp>
  __device__ __forceinline__ void value_and_grad(LaneGroup<T, kOneWarp>&, const Owned<2>& own,
                                                 int, T*, const T (&x)[2], T (&g)[2], T& terms,
                                                 T&) const {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!own.has[e]) continue;
      const T r = x[e] - x_star[own.idx[e]];
      const T dr = diag[own.idx[e]] * r;
      terms += dr * r;
      g[e] = -dr;
    }
  }

  __device__ __forceinline__ T value(T terms, T, int) const { return T(-0.5) * terms; }

  template <bool kOneWarp>
  __device__ __forceinline__ T value_along(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own,
                                           int n, T*, const T (&x)[2], const T (&d)[2],
                                           T alpha) const {
    T v[1] = {T(0)};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!own.has[e]) continue;
      const T r = (x[e] + alpha * d[e]) - x_star[own.idx[e]];
      v[0] += diag[own.idx[e]] * r * r;
    }
    grp.sum(v);
    return value(v[0], T(0), n);
  }
};

// models/logistic.py: Σ_i [y_i log σ(z_i) + (1 - y_i) log σ(-z_i)] -
// (1/2) Σ w² / prior_scale², z = X w, with X (n_obs, n) row-major and y
// (n_obs) in device memory, read by every lane (through L2). log σ(z) =
// min(z, 0) - log1p(exp(-|z|)), as torch's logsigmoid; σ(z) in its stable
// two-branch form. The gradient is Xᵀ(y - σ(z)) - w / prior_scale².
//
// Every row's logit reads the whole of w, so the point goes to shared
// memory (n values). The logits are taken over the rows in chunks of the
// lane group's threads: thread t takes row i0 + t's dot product Σ_j X[i, j]
// w_j and its residual y_i - σ(z_i), which it puts in shared memory (one
// chunk); the column owners then accumulate g_j += X[i, j] r_i over the
// chunk's rows, in row order. The scratch is one chunk whatever n_obs is,
// so what fits depends on n alone. A trial needs no residuals: each thread
// sums its rows' terms. Barriers: after the point is written, and before
// and after the owners read a chunk's residuals.
template <typename T>
struct LogisticObjective {
  const T* __restrict__ X;
  const T* __restrict__ y;
  int n_obs;
  T prior_sq;  // prior_scale²

  static constexpr int kOwned = 2;
  // the point (n) and one chunk of residuals (the lane's threads)
  static size_t extra_values(int n) { return size_t(n) + size_t(32 * lane_warps(n)); }

  __device__ __forceinline__ Owned<2> owned(int n) const { return owned_columns(n); }

  __device__ __forceinline__ static T row_dot(const T* __restrict__ row, const T* w, int n) {
    T z = T(0);
    for (int j = 0; j < n; ++j) z = z + row[j] * w[j];
    return z;
  }

  // y log σ(z) + (1 - y) log σ(-z)
  __device__ __forceinline__ static T loglik_term(T z, T yi) {
    const T e = log1p_of(exp_of(-fabs(z)));
    const T lp = (z < T(0) ? z : T(0)) - e;
    const T lm = (-z < T(0) ? -z : T(0)) - e;
    return yi * lp + (T(1) - yi) * lm;
  }

  __device__ __forceinline__ static T sigmoid(T z) {
    if (z >= T(0)) return T(1) / (T(1) + exp_of(-z));
    const T e = exp_of(z);
    return e / (T(1) + e);
  }

  // terms: the thread's rows' log-likelihood terms; extra: Σ w² of its entries
  template <bool kOneWarp>
  __device__ __forceinline__ void value_and_grad(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own,
                                                 int n, T* scratch, const T (&x)[2], T (&g)[2],
                                                 T& terms, T& extra) const {
    T* sW = scratch;
    T* sR = scratch + n;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!own.has[e]) continue;
      sW[own.idx[e]] = x[e];
      extra += x[e] * x[e];
    }
    grp.sync();
    T acc[2] = {T(0), T(0)};
    const int chunk = blockDim.x;
    for (int i0 = 0; i0 < n_obs; i0 += chunk) {
      const int i = i0 + threadIdx.x;
      T r = T(0);
      if (i < n_obs) {
        const T z = row_dot(X + size_t(i) * n, sW, n);
        const T yi = y[i];
        terms += loglik_term(z, yi);
        r = yi - sigmoid(z);
      }
      sR[threadIdx.x] = r;
      grp.sync();
      const int rows = min(chunk, n_obs - i0);
      const T* Xc = X + size_t(i0) * n;
      for (int t = 0; t < rows; ++t) {
        const T rt = sR[t];
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[e] = acc[e] + Xc[size_t(t) * n + own.idx[e]] * rt;
      }
      grp.sync();  // the next chunk rewrites sR
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) g[e] = acc[e] - x[e] / prior_sq;
  }

  __device__ __forceinline__ T value(T terms, T extra, int) const {
    return terms + (T(-0.5) * extra) / prior_sq;
  }

  template <bool kOneWarp>
  __device__ __forceinline__ T value_along(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own,
                                           int n, T* scratch, const T (&x)[2], const T (&d)[2],
                                           T alpha) const {
    T* sW = scratch;
    T v[2] = {T(0), T(0)};  // the rows' terms, Σ w²
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!own.has[e]) continue;
      const T w = x[e] + alpha * d[e];
      sW[own.idx[e]] = w;
      v[1] += w * w;
    }
    grp.sync();
    for (int i = threadIdx.x; i < n_obs; i += blockDim.x) {
      v[0] += loglik_term(row_dot(X + size_t(i) * n, sW, n), y[i]);
    }
    grp.sum(v);
    return value(v[0], v[1], n);
  }
};

}  // namespace qnm
