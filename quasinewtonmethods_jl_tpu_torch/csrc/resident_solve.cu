// Whole-solve resident BFGS engine B3, for Hopper (sm_90a): the seven
// objectives written by hand (resident_objectives.cuh), each instantiated
// in float and double, with their C entry points and the host side's
// queries. The kernel, its design and its launch are in resident_solve.cuh,
// which the objectives the port generates from a trace include as well.

#include "resident_solve.cuh"

namespace {
// The objectives by the numbers the entry points below take.
enum ObjectiveId {
  kRosenbrock = 0,
  kQuadratic = 1,
  kLogistic = 2,
  kFunnel = 3,
  kMixture = 4,
  kPoisson = 5,
  kAr1 = 6
};

// f(objective) for an objective of the given number that holds only its
// sizes (`size`: the AR(1)'s number of steps; the others have none that
// their shared memory depends on): the host side's queries.
template <typename T, typename F>
auto with_objective(int objective, int size, F&& f) {
  switch (objective) {
    case kQuadratic:
      return f(qnm::QuadraticObjective<T>{});
    case kLogistic:
      return f(qnm::LogisticObjective<T>{});
    case kFunnel:
      return f(qnm::FunnelObjective<T>{});
    case kMixture:
      return f(qnm::MixtureObjective<T>{});
    case kPoisson:
      return f(qnm::PoissonObjective<T>{});
    case kAr1: {
      qnm::Ar1Objective<T> ar1{};
      ar1.n_steps = size;
      return f(ar1);
    }
    default:
      return f(qnm::RosenbrockObjective<T>{});
  }
}

template <typename T>
size_t smem_bytes_of(int objective, int n, int size) {
  return with_objective<T>(objective, size, [n](const auto& obj) {
    return smem_bytes(n, sizeof(T), obj.extra_values(n));
  });
}

template <typename T>
int occupancy_of(int objective, int n, int size, int* regs, int* threads, int* blocks_per_sm) {
  return with_objective<T>(objective, size, [&](const auto& obj) {
    return qnm::lane_occupancy(launch_for<T>(n, obj), regs, threads, blocks_per_sm);
  });
}

}  // namespace

extern "C" {

// Shared memory one block of the solve asks for, in bytes: for the
// Rosenbrock (and every objective with no scratch), and for each objective
// by its number (ObjectiveId) and size (the AR(1)'s number of steps).
size_t qnm_resident_smem_bytes(int n, int itemsize) { return smem_bytes(n, size_t(itemsize)); }

size_t qnm_resident_objective_smem_bytes(int objective, int n, int size, int itemsize) {
  return itemsize == 4 ? smem_bytes_of<float>(objective, n, size)
                       : smem_bytes_of<double>(objective, n, size);
}

// The solve's launch at n: registers per thread, threads per block and
// blocks per SM (the occupancy calculator's, with the attributes a launch
// sets), for the Rosenbrock and for each objective by its number and size.
// Returns a CUDA error code (0 = success).
int qnm_resident_objective_occupancy(int objective, int n, int size, int itemsize, int* regs,
                                     int* threads, int* blocks_per_sm) {
  return itemsize == 4
             ? occupancy_of<float>(objective, n, size, regs, threads, blocks_per_sm)
             : occupancy_of<double>(objective, n, size, regs, threads, blocks_per_sm);
}

int qnm_resident_occupancy(int n, int itemsize, int* regs, int* threads, int* blocks_per_sm) {
  return qnm_resident_objective_occupancy(kRosenbrock, n, 0, itemsize, regs, threads,
                                          blocks_per_sm);
}

// Every solve entry returns cudaGetLastError() after the launch (0 =
// launched). The Rosenbrock's and the funnel's take no data; the
// quadratic's diag and x* (n each); the GLMs' (logistic, Poisson) X
// (n_obs, n) row-major, y (n_obs) and prior_scale²; the mixture's means
// (K, n), weights (K, normalised) and sigmas (K), K <= 8; the AR(1)'s A
// (n, n) and ys (n_steps, n) row-major, 1/(2 obs_scale²) and prior_scale².
int qnm_resident_solve_f32(QNM_SOLVE_ARGS(float), void* stream) {
  return QNM_SOLVE(float, qnm::RosenbrockObjective<float>{});
}

int qnm_resident_solve_f64(QNM_SOLVE_ARGS(double), void* stream) {
  return QNM_SOLVE(double, qnm::RosenbrockObjective<double>{});
}

int qnm_resident_solve_quadratic_f32(QNM_SOLVE_ARGS(float), const void* diag,
                                     const void* x_star, void* stream) {
  return QNM_SOLVE(float, (qnm::QuadraticObjective<float>{static_cast<const float*>(diag),
                                                          static_cast<const float*>(x_star)}));
}

int qnm_resident_solve_quadratic_f64(QNM_SOLVE_ARGS(double), const void* diag,
                                     const void* x_star, void* stream) {
  return QNM_SOLVE(double, (qnm::QuadraticObjective<double>{static_cast<const double*>(diag),
                                                            static_cast<const double*>(x_star)}));
}

int qnm_resident_solve_logistic_f32(QNM_SOLVE_ARGS(float), const void* data_X,
                                    const void* data_y, int n_obs, float prior_sq,
                                    void* stream) {
  return QNM_SOLVE(float, (qnm::LogisticObjective<float>{static_cast<const float*>(data_X),
                                                         static_cast<const float*>(data_y), n_obs,
                                                         prior_sq}));
}

int qnm_resident_solve_logistic_f64(QNM_SOLVE_ARGS(double), const void* data_X,
                                    const void* data_y, int n_obs, double prior_sq,
                                    void* stream) {
  return QNM_SOLVE(double, (qnm::LogisticObjective<double>{static_cast<const double*>(data_X),
                                                           static_cast<const double*>(data_y),
                                                           n_obs, prior_sq}));
}

int qnm_resident_solve_poisson_f32(QNM_SOLVE_ARGS(float), const void* data_X,
                                   const void* data_y, int n_obs, float prior_sq, void* stream) {
  return QNM_SOLVE(float, (qnm::PoissonObjective<float>{static_cast<const float*>(data_X),
                                                        static_cast<const float*>(data_y), n_obs,
                                                        prior_sq}));
}

int qnm_resident_solve_poisson_f64(QNM_SOLVE_ARGS(double), const void* data_X,
                                   const void* data_y, int n_obs, double prior_sq,
                                   void* stream) {
  return QNM_SOLVE(double, (qnm::PoissonObjective<double>{static_cast<const double*>(data_X),
                                                          static_cast<const double*>(data_y),
                                                          n_obs, prior_sq}));
}

int qnm_resident_solve_funnel_f32(QNM_SOLVE_ARGS(float), void* stream) {
  return QNM_SOLVE(float, qnm::FunnelObjective<float>{});
}

int qnm_resident_solve_funnel_f64(QNM_SOLVE_ARGS(double), void* stream) {
  return QNM_SOLVE(double, qnm::FunnelObjective<double>{});
}

int qnm_resident_solve_mixture_f32(QNM_SOLVE_ARGS(float), const void* means,
                                   const void* weights, const void* sigmas, int K,
                                   void* stream) {
  return QNM_SOLVE(float, (qnm::MixtureObjective<float>{static_cast<const float*>(means),
                                                        static_cast<const float*>(weights),
                                                        static_cast<const float*>(sigmas), K}));
}

int qnm_resident_solve_mixture_f64(QNM_SOLVE_ARGS(double), const void* means,
                                   const void* weights, const void* sigmas, int K,
                                   void* stream) {
  return QNM_SOLVE(double, (qnm::MixtureObjective<double>{static_cast<const double*>(means),
                                                          static_cast<const double*>(weights),
                                                          static_cast<const double*>(sigmas),
                                                          K}));
}

int qnm_resident_solve_ar1_f32(QNM_SOLVE_ARGS(float), const void* A, const void* ys,
                               int n_steps, float inv2s2, float prior_sq, void* stream) {
  return QNM_SOLVE(float, (qnm::Ar1Objective<float>{static_cast<const float*>(A),
                                                    static_cast<const float*>(ys), n_steps,
                                                    inv2s2, prior_sq}));
}

int qnm_resident_solve_ar1_f64(QNM_SOLVE_ARGS(double), const void* A, const void* ys,
                               int n_steps, double inv2s2, double prior_sq, void* stream) {
  return QNM_SOLVE(double, (qnm::Ar1Objective<double>{static_cast<const double*>(A),
                                                      static_cast<const double*>(ys), n_steps,
                                                      inv2s2, prior_sq}));
}

}  // extern "C"
