// The objectives the resident solver B3 (resident_solve.cu) evaluates on
// the card: the split Rosenbrock, the ill-conditioned quadratic, the GLM
// posteriors (logistic and Poisson: one row loop, two links), Neal's
// funnel, the Gaussian mixture and the AR(1)-with-drift state-space MAP. The JAX kernel traces any jnp objective into its body, closed
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
//   prepare(...)         once per lane before the first evaluation: puts
//                        constant data in its shared memory (the AR(1)'s A)
//                        and publishes them; empty for the others;
//   extra_values(n)      the shared memory it needs beyond the solver's, in
//                        values (host side too, on an objective that holds
//                        only its sizes).
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
__device__ __forceinline__ float log_of(float v) { return logf(v); }
__device__ __forceinline__ double log_of(double v) { return log(v); }

// models/rosenbrock.py: -Σ 100 r² + (1 - a)², r = b - a², over the pairs
// (a, b) = (x[i], x[half + i]), and -(1 - x[n-1])² for odd n. A thread owns
// the pair i = threadIdx.x < n/2, and thread 0 also the odd-n tail (n/2
// never exceeds the lane's threads, so a thread owns at most one pair).
// No data; the top of an iteration computes rosenbrock_value_and_grad's
// expressions, a trial rosenbrock_logdensity's.
template <typename T>
struct RosenbrockObjective {
  static constexpr int kOwned = 3;
  size_t extra_values(int) const { return 0; }
  template <bool kOneWarp>
  __device__ __forceinline__ void prepare(LaneGroup<T, kOneWarp>&, int, T*) const {}

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
  size_t extra_values(int) const { return 0; }
  template <bool kOneWarp>
  __device__ __forceinline__ void prepare(LaneGroup<T, kOneWarp>&, int, T*) const {}

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

// The GLM posteriors: Σ_i term(z_i, y_i) - (1/2) Σ w² / prior_scale², z =
// X w, with X (n_obs, n) row-major and y (n_obs) in device memory, read by
// every lane (through L2). The gradient is Xᵀ r - w / prior_scale², r_i =
// residual(z_i, y_i) = ∂term/∂z_i. The link is a policy:
//   LogitLink (models/logistic.py): term y log σ(z) + (1 - y) log σ(-z),
//     log σ(z) = min(z, 0) - log1p(exp(-|z|)) as torch's logsigmoid;
//     residual y - σ(z), σ in its stable two-branch form;
//   LogLink (models/poisson.py): term y·z - exp(z), residual y - exp(z).
//
// Every row's z reads the whole of w, so the point goes to shared memory
// (n values). The rows are taken in chunks of the lane group's threads:
// thread t takes row i0 + t's dot product Σ_j X[i, j] w_j and its residual,
// which it puts in shared memory (one chunk); the column owners then
// accumulate g_j += X[i, j] r_i over the chunk's rows, in row order. The
// scratch is one chunk whatever n_obs is, so what fits depends on n alone.
// A trial needs no residuals: each thread sums its rows' terms. Barriers:
// after the point is written, and before and after the owners read a
// chunk's residuals.
struct LogitLink {
  template <typename T>
  __device__ __forceinline__ static T term(T z, T yi) {
    const T e = log1p_of(exp_of(-fabs(z)));
    const T lp = (z < T(0) ? z : T(0)) - e;
    const T lm = (-z < T(0) ? -z : T(0)) - e;
    return yi * lp + (T(1) - yi) * lm;
  }

  template <typename T>
  __device__ __forceinline__ static T sigmoid(T z) {
    if (z >= T(0)) return T(1) / (T(1) + exp_of(-z));
    const T e = exp_of(z);
    return e / (T(1) + e);
  }

  template <typename T>
  __device__ __forceinline__ static T residual(T z, T yi) {
    return yi - sigmoid(z);
  }
};

struct LogLink {
  template <typename T>
  __device__ __forceinline__ static T term(T z, T yi) {
    return yi * z - exp_of(z);
  }

  template <typename T>
  __device__ __forceinline__ static T residual(T z, T yi) {
    return yi - exp_of(z);
  }
};

template <typename T, typename Link>
struct GlmObjective {
  const T* __restrict__ X;
  const T* __restrict__ y;
  int n_obs;
  T prior_sq;  // prior_scale²

  static constexpr int kOwned = 2;
  // the point (n) and one chunk of residuals (the lane's threads)
  size_t extra_values(int n) const { return size_t(n) + size_t(32 * lane_warps(n)); }
  template <bool kOneWarp>
  __device__ __forceinline__ void prepare(LaneGroup<T, kOneWarp>&, int, T*) const {}

  __device__ __forceinline__ Owned<2> owned(int n) const { return owned_columns(n); }

  __device__ __forceinline__ static T row_dot(const T* __restrict__ row, const T* w, int n) {
    T z = T(0);
    for (int j = 0; j < n; ++j) z = z + row[j] * w[j];
    return z;
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
        terms += Link::term(z, yi);
        r = Link::residual(z, yi);
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
      v[0] += Link::term(row_dot(X + size_t(i) * n, sW, n), y[i]);
    }
    grp.sum(v);
    return value(v[0], v[1], n);
  }
};

template <typename T>
using LogisticObjective = GlmObjective<T, LogitLink>;
template <typename T>
using PoissonObjective = GlmObjective<T, LogLink>;

// models/funnel.py: -v²/9/2 - (n-1)·v/2 - e^{-v}·Σ x²/2 over θ = (v, x),
// the update's column ownership, v (entry 0) with thread 0. v's gradient
// -v/9 - (n-1)/2 + e^{-v}·Σx²/2 needs Σx² of the whole lane, and every
// x_i's gradient -e^{-v}·x_i needs v: one lane sum, in which only v's
// owner adds v, gives both to every thread. The value is then known on
// every thread, and thread 0 alone adds it to the solver's sum. No data.
template <typename T>
struct FunnelObjective {
  static constexpr int kOwned = 2;
  size_t extra_values(int) const { return 0; }
  template <bool kOneWarp>
  __device__ __forceinline__ void prepare(LaneGroup<T, kOneWarp>&, int, T*) const {}

  __device__ __forceinline__ Owned<2> owned(int n) const { return owned_columns(n); }

  // (v, Σ x²) of the lane's point th, on every thread
  template <bool kOneWarp>
  __device__ __forceinline__ static void spread(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own,
                                                const T (&th)[2], T& v, T& xx) {
    T s[2] = {T(0), T(0)};  // Σ x², v
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!own.has[e]) continue;
      if (own.idx[e] == 0) {
        s[1] = th[e];
      } else {
        s[0] += th[e] * th[e];
      }
    }
    grp.sum(s);
    xx = s[0];
    v = s[1];
  }

  __device__ __forceinline__ static T value_at(T v, T xx, int n) {
    return ((T(-0.5) * v) * v) / T(9) - (T(0.5) * T(n - 1)) * v - (T(0.5) * exp_of(-v)) * xx;
  }

  // terms: the value, on thread 0 only
  template <bool kOneWarp>
  __device__ __forceinline__ void value_and_grad(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own,
                                                 int n, T*, const T (&x)[2], T (&g)[2], T& terms,
                                                 T&) const {
    T v, xx;
    spread(grp, own, x, v, xx);
    const T h = T(0.5) * exp_of(-v);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      g[e] = own.idx[e] == 0 ? (-v / T(9) - T(0.5) * T(n - 1)) + h * xx : -(h * (T(2) * x[e]));
    }
    if (threadIdx.x == 0) terms = value_at(v, xx, n);
  }

  __device__ __forceinline__ T value(T terms, T, int) const { return terms; }

  template <bool kOneWarp>
  __device__ __forceinline__ T value_along(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own,
                                           int n, T*, const T (&x)[2], const T (&d)[2],
                                           T alpha) const {
    T th[2], v, xx;
#pragma unroll
    for (int e = 0; e < 2; ++e) th[e] = x[e] + alpha * d[e];
    spread(grp, own, th, v, xx);
    return value_at(v, xx, n);
  }
};

// models/mixture.py: logsumexp_k comp_k, comp_k = log w_k - (1/2) d2_k /
// sigma_k² - n log sigma_k, d2_k = Σ_j (x_j - mu_kj)², with means (K, n),
// weights (K) and sigmas (K) in device memory; the column owners read
// means' rows coalesced. The K distances are one lane sum (so K <= 8,
// kMaxComponents: a compile-time maximum, which keeps the components in
// registers); every thread then takes the max-shifted logsumexp as
// torch.logsumexp does (an infinite max shifts by 0). The gradient of an
// owned entry is Σ_k (-p_k / sigma_k²)(x_j - mu_kj), p = exp(comp - lse),
// the logsumexp's own backward. Thread 0 alone adds the value to the
// solver's sum. No shared memory.
constexpr int kMaxComponents = kMaxSums;

template <typename T>
struct MixtureObjective {
  const T* __restrict__ means;
  const T* __restrict__ weights;
  const T* __restrict__ sigmas;
  int K;

  static constexpr int kOwned = 2;
  size_t extra_values(int) const { return 0; }
  template <bool kOneWarp>
  __device__ __forceinline__ void prepare(LaneGroup<T, kOneWarp>&, int, T*) const {}

  __device__ __forceinline__ Owned<2> owned(int n) const { return owned_columns(n); }

  // the components comp_k and their logsumexp at the lane's point th, on
  // every thread
  template <bool kOneWarp>
  __device__ __forceinline__ T components(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own, int n,
                                          const T (&th)[2], T (&comp)[kMaxComponents]) const {
    T d2[kMaxComponents];
#pragma unroll
    for (int k = 0; k < kMaxComponents; ++k) {
      d2[k] = T(0);
      if (k >= K) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!own.has[e]) continue;
        const T r = th[e] - means[size_t(k) * n + own.idx[e]];
        d2[k] += r * r;
      }
    }
    grp.sum(d2);
    T top = -INFINITY;  // a NaN component makes the sum below NaN, as amax would
#pragma unroll
    for (int k = 0; k < kMaxComponents; ++k) {
      if (k >= K) continue;
      const T s = sigmas[k];
      comp[k] = (log_of(weights[k]) - (T(0.5) * d2[k]) / (s * s)) - T(n) * log_of(s);
      top = comp[k] > top ? comp[k] : top;
    }
    const T shift = isinf(top) ? T(0) : top;
    T total = T(0);
#pragma unroll
    for (int k = 0; k < kMaxComponents; ++k) {
      if (k < K) total += exp_of(comp[k] - shift);
    }
    return log_of(total) + shift;
  }

  // terms: the value, on thread 0 only
  template <bool kOneWarp>
  __device__ __forceinline__ void value_and_grad(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own,
                                                 int n, T*, const T (&x)[2], T (&g)[2], T& terms,
                                                 T&) const {
    T comp[kMaxComponents];
    const T lse = components(grp, own, n, x, comp);
    T acc[2] = {T(0), T(0)};
#pragma unroll
    for (int k = 0; k < kMaxComponents; ++k) {
      if (k >= K) continue;
      const T s = sigmas[k];
      const T coef = -exp_of(comp[k] - lse) / (s * s);
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[e] += coef * (x[e] - means[size_t(k) * n + own.idx[e]]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) g[e] = acc[e];
    if (threadIdx.x == 0) terms = lse;
  }

  __device__ __forceinline__ T value(T terms, T, int) const { return terms; }

  template <bool kOneWarp>
  __device__ __forceinline__ T value_along(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own,
                                           int n, T*, const T (&x)[2], const T (&d)[2],
                                           T alpha) const {
    T th[2], comp[kMaxComponents];
#pragma unroll
    for (int e = 0; e < 2; ++e) th[e] = x[e] + alpha * d[e];
    return components(grp, own, n, th, comp);
  }
};

// models/statespace.py: Σ_t -(1/(2s²)) Σ_i (y_ti - z_ti)² - (1/2) Σ w² /
// prior_scale² over the recursion z_t = A z_{t-1} + w, z_0 = 0, t = 1..T,
// with ys (T, n) in device memory and A (n, n) copied once per lane into
// shared memory (`prepare`). The hand-written counterpart of the JAX
// package's scan-bodied objective. Column ownership: the forward recursion
// is one matvec per step, row i of A against z_{t-1} for each owned i,
// with every z_t kept in shared memory (T + 1 rows of n, row 0 the zero
// start) for the adjoint; the gradient is the reverse recursion
//   mu_T = ∇l_T,  mu_t = ∇l_t + Aᵀ mu_{t+1},  ∇_w = Σ_t mu_t - w / p²,
// ∇l_t = (2 (y_t - z_t))/(2s²), with mu in two shared buffers of n used in
// turn. One barrier per step publishes z_t (or mu_t); a trial runs the
// forward recursion only. Shared memory: n² + (T + 1)·n + 2n values, so
// what fits depends on n and T.
template <typename T>
struct Ar1Objective {
  const T* __restrict__ A;
  const T* __restrict__ ys;
  int n_steps;
  T inv2s2;    // 1 / (2 obs_scale²)
  T prior_sq;  // prior_scale²

  static constexpr int kOwned = 2;
  size_t extra_values(int n) const {
    return size_t(n) * n + size_t(n_steps + 1) * n + 2 * size_t(n);
  }

  __device__ __forceinline__ Owned<2> owned(int n) const { return owned_columns(n); }

  template <bool kOneWarp>
  __device__ __forceinline__ void prepare(LaneGroup<T, kOneWarp>& grp, int n, T* scratch) const {
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) scratch[i] = A[i];
    for (int i = threadIdx.x; i < n; i += blockDim.x) scratch[n * n + i] = T(0);  // z_0
    grp.sync();
  }

  // The forward recursion at the lane's drift w: z_1..z_T into shared
  // memory; returns the thread's Σ_t Σ_owned (y_t - z_t)².
  template <bool kOneWarp>
  __device__ __forceinline__ T forward(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own, int n,
                                       T* scratch, const T (&w)[2]) const {
    const T* sA = scratch;
    T* sZ = scratch + size_t(n) * n;
    T acc = T(0);
    for (int t = 1; t <= n_steps; ++t) {
      const T* zp = sZ + size_t(t - 1) * n;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!own.has[e]) continue;
        const int i = own.idx[e];
        T m = T(0);
        for (int j = 0; j < n; ++j) m = m + sA[i * n + j] * zp[j];
        const T z = m + w[e];
        sZ[size_t(t) * n + i] = z;
        const T r = ys[size_t(t - 1) * n + i] - z;
        acc += r * r;
      }
      grp.sync();  // publishes z_t
    }
    return acc;
  }

  // terms: the thread's Σ_t Σ_owned (y_t - z_t)²; extra: Σ w² of its entries
  template <bool kOneWarp>
  __device__ __forceinline__ void value_and_grad(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own,
                                                 int n, T* scratch, const T (&x)[2], T (&g)[2],
                                                 T& terms, T& extra) const {
    const T* sA = scratch;
    const T* sZ = scratch + size_t(n) * n;
    T* sMu = scratch + size_t(n) * n + size_t(n_steps + 1) * n;
    terms = forward(grp, own, n, scratch, x);
    T acc[2] = {T(0), T(0)};
    for (int t = n_steps; t >= 1; --t) {
      const T* next = sMu + ((t + 1) & 1) * n;  // mu_{t+1}
      T* cur = sMu + (t & 1) * n;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!own.has[e]) continue;
        const int i = own.idx[e];
        T mu = inv2s2 * (T(2) * (ys[size_t(t - 1) * n + i] - sZ[size_t(t) * n + i]));
        if (t < n_steps) {
          T m = T(0);
          for (int j = 0; j < n; ++j) m = m + sA[j * n + i] * next[j];
          mu = mu + m;
        }
        cur[i] = mu;
        acc[e] += mu;
      }
      grp.sync();  // publishes mu_t
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (own.has[e]) extra += x[e] * x[e];
      g[e] = acc[e] - x[e] / prior_sq;
    }
  }

  __device__ __forceinline__ T value(T terms, T extra, int) const {
    return -inv2s2 * terms - (T(0.5) * extra) / prior_sq;
  }

  template <bool kOneWarp>
  __device__ __forceinline__ T value_along(LaneGroup<T, kOneWarp>& grp, const Owned<2>& own,
                                           int n, T* scratch, const T (&x)[2], const T (&d)[2],
                                           T alpha) const {
    T w[2], v[2] = {T(0), T(0)};  // Σ (y - z)², Σ w²
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      w[e] = x[e] + alpha * d[e];
      if (own.has[e]) v[1] += w[e] * w[e];
    }
    v[0] = forward(grp, own, n, scratch, w);
    grp.sum(v);
    return value(v[0], v[1], n);
  }
};

}  // namespace qnm
