// Kernel 6's warp route: the whole fixed-trip QP interior point of
// fused_qp.cuh for the QPs past the register caps, N + K <= 192 with any
// number of box rows, one warp per instance.
//
// Replaces, with fused_qp.cuh's register route, the TPU kernel
// mini_opt_tpu/ops/pallas_qp.py::_make_qp_kernel (launched at
// pallas_qp.py:262), which takes any N, K and M.
//
// What bounds it on this card: one instance's serial chain, now through a
// (D, D) condensed KKT matrix (D = N + K) that no thread's registers hold.
// The right-looking LDL^T step is D^2 / 2 independent updates, so a warp
// shares it; the back substitution is a chain of D^2 / 2 dependent
// subtractions in the plain version's order, which no split keeps.
//
// What the design does about it: one warp per instance and W instances a
// CTA (ops/fused_qp.py::launch_plan; the launcher checks W's slabs against
// the card's shared memory). The instance's slab of the CTA's dynamic
// shared memory holds the condensed lower triangle packed by columns, the
// iterates x, y, s, z, the residuals and the step, and the box rows' a and
// b. Lane l takes variables, equality rows and box rows l, l + 32, ...;
// G, c, A and b are read from the caller's tensors at their strides where
// they are used. A box row may sit on any variable, several on one: the
// rows of each variable, in row order, come from a table (`rows`: var[M],
// then the CSR ptr[N + 1] and idx[M] of rows by variable) that
// ops/fused_qp.py builds once per ineq_var and device. Every scalar sum and
// minimum over the box rows has its terms written to a scratch slot and
// read back in index order on every lane, so each per-instance decision is
// warp-uniform. A call is one device kernel.
//
// The order of operations is kernel 6's own (ops/fused_ik.py's
// _ldlt_factor_unrolled and _ldlt_apply, not kernel 2's warp routines): the
// factor subtracts (L_ik L_jk) d_k from entry (i, j) in pivot order, the
// forward substitution L_ik y_k in ascending k, the back substitution
// L_ki y_k in ascending k for each row i, one lane running that chain. NaN
// semantics are the register route's (nmax / nmin). Built without FMA
// contraction, the route reproduces ops/fused_qp.py::_fused_qp_plain bit
// for bit.
#include "fused_qp.cuh"

namespace mo {
namespace qp {

constexpr int kWarpLanes = 32;
constexpr int kWarpMaxD = 192;    // ops/fused_qp.py WARP_MAX_D
constexpr int kMaxWarpsPerCta = 4;  // ops/fused_qp.py WARPS_PER_CTA

__host__ __device__ inline int tri(int n) { return n * (n + 1) / 2; }
// Column j of the packed lower triangle starts at slot col(j): entry (i, j),
// i >= j, is slot col(j) + i - j, so that the trailing triangle of pivot k
// is the contiguous run of slots from col(k + 1).
__host__ __device__ inline int col(int j, int D) { return j * D - j * (j - 1) / 2; }

// Slots of one instance's slab: the triangle, sol (D), x and r_d (N), y and
// r_pe (K), and twelve arrays of M (ia, ib, s, z, r_pi, zs, r_c, q, ds, dz
// and two scratch rows); ops/fused_qp.py::warp_slab_slots mirrors it.
__host__ __device__ inline long long warp_slab_slots(int N, int K, int M) {
  const int D = N + K;
  return static_cast<long long>(tri(D)) + D + 2 * N + 2 * K + 12LL * M;
}
// Bytes of one slab, whole 16-byte units.
template <typename T>
__host__ __device__ inline long long warp_slab_bytes(int N, int K, int M) {
  return (warp_slab_slots(N, K, M) * static_cast<long long>(sizeof(T)) + 15) / 16 * 16;
}

template <typename T>
__device__ __forceinline__ T ftb_candidate(T v, T dv, T tau) {
  const bool blocking = (v + dv <= T(0)) && (fabs(dv) > T(0));
  const T cand = -tau * v / (blocking ? dv : T(1));
  return blocking ? cand : T(1);
}

template <typename T>
__global__ void __launch_bounds__(kWarpLanes * kMaxWarpsPerCta)
    fused_qp_warp_kernel(const Tensors t, int B, int N, int K, int M, const int* __restrict__ rows,
                         long long slab_bytes, const Schedule sch) {
  extern __shared__ __align__(16) unsigned char qp_slab[];
  const int lane = threadIdx.x % kWarpLanes, w = threadIdx.x / kWarpLanes;
  const long long inst = static_cast<long long>(blockIdx.x) * (blockDim.x / kWarpLanes) + w;
  if (inst >= B) return;  // the whole warp, before its first __syncwarp
  const int D = N + K;
  T* H = reinterpret_cast<T*>(qp_slab + w * slab_bytes);
  T* sol = H + tri(D);
  T* x = sol + D;
  T* rd = x + N;
  T* y = rd + N;
  T* rpe = y + K;
  T* ia = rpe + K;
  T* ib = ia + M;
  T* s = ib + M;
  T* z = s + M;
  T* rpi = z + M;
  T* zs = rpi + M;
  T* rc = zs + M;
  T* q = rc + M;
  T* ds = q + M;
  T* dz = ds + M;
  T* ta = dz + M;
  T* tb = ta + M;
  const int* var = rows;
  const int* ptr = rows + M;
  const int* idx = rows + M + N + 1;

  const T* __restrict__ Gp = static_cast<const T*>(t.G) + inst * t.sG[0];
  const T* __restrict__ cp = static_cast<const T*>(t.c) + inst * t.sc[0];
  const T* __restrict__ Ap = static_cast<const T*>(t.A) + inst * t.sA[0];
  const T* __restrict__ bp = static_cast<const T*>(t.b) + inst * t.sb[0];
  const T* __restrict__ iap = static_cast<const T*>(t.ia) + inst * t.sia[0];
  const T* __restrict__ ibp = static_cast<const T*>(t.ib) + inst * t.sib[0];
  auto Gl = [&](int i, int j) { return Gp[i * t.sG[1] + j * t.sG[2]]; };  // i >= j
  auto Aij = [&](int k, int j) { return Ap[k * t.sA[1] + j * t.sA[2]]; };
  const T zero = T(0), one = T(1);

  for (int m = lane; m < M; m += kWarpLanes) {
    ia[m] = iap[m * t.sia[1]];
    ib[m] = ibp[m * t.sib[1]];
  }
  __syncwarp();

  // Condensed lower triangle: G's, then sig_m = a_m^2 z_m / s_m (or 0) added
  // on the diagonal of var[m] in row order, the equality rows below, a zero
  // (K, K) block.
  auto assemble = [&](bool with_sig) {
    for (int j = 0; j < D; ++j) {
      T* Hc = H + col(j, D) - j;  // Hc[i] = entry (i, j)
      for (int i = j + lane; i < D; i += kWarpLanes) {
        Hc[i] = i < N ? Gl(i, j) : (j < N ? Aij(i - N, j) : zero);
      }
    }
    __syncwarp();
    for (int v = lane; v < N; v += kWarpLanes) {
      T h = H[col(v, D)];
      for (int p = ptr[v]; p < ptr[v + 1]; ++p) {
        const int m = idx[p];
        h = h + (with_sig ? ia[m] * ia[m] * zs[m] : zero);
      }
      H[col(v, D)] = h;
    }
    __syncwarp();
  };

  // Unpivoted LDL^T in place: the pivots on the diagonal, L below it.
  // Step k divides column k by d_k, then subtracts (L_ik L_jk) d_k from
  // every entry (i, j) of the trailing triangle, slots l, l + 32, ... on
  // lane l; each entry so takes its terms in pivot order, as the plain
  // version's left-looking loop does.
  auto factor = [&]() {
    for (int k = 0; k < D; ++k) {
      T* Lk = H + col(k, D) - k;  // Lk[i] = entry (i, k)
      const T dk = Lk[k];
      for (int i = k + 1 + lane; i < D; i += kWarpLanes) Lk[i] = Lk[i] / dk;
      __syncwarp();
      int j = k + 1, i = j + lane;
      while (j < D && i >= D) {
        i = i - D + j + 1;
        ++j;
      }
      while (j < D) {
        T* a = H + col(j, D) - j + i;
        *a = *a - Lk[i] * Lk[j] * dk;
        i += kWarpLanes;
        while (j < D && i >= D) {
          i = i - D + j + 1;
          ++j;
        }
      }
      __syncwarp();
    }
  };

  // Solve with the factor, sol in place: the forward substitution by
  // columns (row i takes L_ik y_k for k = 0, 1, ... as the plain version's
  // rows do), the division, then the back substitution row by row on lane
  // 0 (row i takes L_ki y_k for k = i + 1, i + 2, ...).
  auto apply = [&]() {
    for (int k = 0; k + 1 < D; ++k) {
      const T* Lk = H + col(k, D) - k;
      const T yk = sol[k];
      for (int i = k + 1 + lane; i < D; i += kWarpLanes) sol[i] = sol[i] - Lk[i] * yk;
      __syncwarp();
    }
    for (int i = lane; i < D; i += kWarpLanes) sol[i] = sol[i] / H[col(i, D)];
    __syncwarp();
    if (lane == 0) {
      for (int i = D - 2; i >= 0; --i) {
        const T* Li = H + col(i, D) - i;  // Li[k] = entry (k, i)
        T acc = sol[i];
        for (int k = i + 1; k < D; ++k) acc = acc - Li[k] * sol[k];
        sol[i] = acc;
      }
    }
    __syncwarp();
  };

  // Initial guess (qp.cc:439-482).
  if (sch.has_eq_guess) {
    assemble(false);
    factor();
    for (int i = lane; i < N; i += kWarpLanes) sol[i] = -cp[i * t.sc[1]];
    for (int k = lane; k < K; k += kWarpLanes) sol[N + k] = -bp[k * t.sb[1]];
    __syncwarp();
    apply();
    for (int i = lane; i < N; i += kWarpLanes) x[i] = sol[i];
    for (int k = lane; k < K; k += kWarpLanes) y[k] = -sol[N + k];
  } else {
    for (int i = lane; i < N; i += kWarpLanes) x[i] = zero;
    for (int k = lane; k < K; k += kWarpLanes) y[k] = zero;
  }
  __syncwarp();
  // Clamp into the feasible half-lines in row order, then
  // s = max(1e-9, a x + b), z = 1 / s.
  for (int v = lane; v < N; v += kWarpLanes) {
    T xv = x[v];
    for (int p = ptr[v]; p < ptr[v + 1]; ++p) {
      const int m = idx[p];
      const T tv = ia[m] * xv + ib[m];
      xv = xv + (tv < zero ? -tv / ia[m] : zero);
    }
    x[v] = xv;
  }
  __syncwarp();
  for (int m = lane; m < M; m += kWarpLanes) {
    s[m] = nmax(T(1e-9), ia[m] * x[var[m]] + ib[m]);
    z[m] = one / s[m];
  }
  __syncwarp();

  // Elimination, condensed solve, back-substitution (qp.cc:318-364):
  // q_m = (r_c + corr - mu) / s with corr = ds dz of the last solve (the
  // Mehrotra corrector) or 0; leaves dx in sol[0, N), -dy in sol[N, D),
  // ds and dz.
  auto solve_step = [&](T mu_v, bool corr) {
    for (int m = lane; m < M; m += kWarpLanes) {
      const T cm = corr ? ds[m] * dz[m] : zero;
      q[m] = (rc[m] + cm - mu_v) / s[m];
    }
    __syncwarp();
    for (int v = lane; v < N; v += kWarpLanes) {
      T acc = rd[v];
      for (int p = ptr[v]; p < ptr[v + 1]; ++p) {
        const int m = idx[p];
        acc = acc + ia[m] * (zs[m] * rpi[m] + q[m]);
      }
      sol[v] = -acc;
    }
    for (int k = lane; k < K; k += kWarpLanes) sol[N + k] = -rpe[k];
    __syncwarp();
    apply();
    for (int m = lane; m < M; m += kWarpLanes) {
      ds[m] = ia[m] * sol[var[m]] + rpi[m];
      dz[m] = -zs[m] * ds[m] - q[m];
    }
    __syncwarp();
  };

  // Fraction to the boundary of s along ds and z along dz: each row's
  // candidate to scratch, then the minima in row order on every lane.
  auto ftb = [&](T tau_v, T& alpha_s, T& alpha_z) {
    for (int m = lane; m < M; m += kWarpLanes) {
      ta[m] = ftb_candidate(s[m], ds[m], tau_v);
      tb[m] = ftb_candidate(z[m], dz[m], tau_v);
    }
    __syncwarp();
    T as = one, az = one;
    for (int m = 0; m < M; ++m) {
      as = nmin(as, ta[m]);
      az = nmin(az, tb[m]);
    }
    alpha_s = as;
    alpha_z = az;
    __syncwarp();
  };

  // The sum of ta[0..M) from 0, in row order, on every lane.
  auto sum_rows = [&]() {
    __syncwarp();
    T acc = zero;
    for (int m = 0; m < M; ++m) acc = acc + ta[m];
    __syncwarp();
    return acc;
  };

  T mu = one;
  const T tau = T(0.995);
  const T sigma = static_cast<T>(sch.sigma);
  for (int it = 0; it < sch.iterations; ++it) {
    // KKT residuals (qp.cc:391-420).
    for (int i = lane; i < N; i += kWarpLanes) {
      T acc = cp[i * t.sc[1]];
      for (int j = 0; j < N; ++j) acc = acc + (i >= j ? Gl(i, j) : Gl(j, i)) * x[j];
      for (int k = 0; k < K; ++k) acc = acc - Aij(k, i) * y[k];
      for (int p = ptr[i]; p < ptr[i + 1]; ++p) {
        const int m = idx[p];
        acc = acc - ia[m] * z[m];
      }
      rd[i] = acc;
    }
    for (int k = lane; k < K; k += kWarpLanes) {
      T acc = bp[k * t.sb[1]];
      for (int j = 0; j < N; ++j) acc = acc + Aij(k, j) * x[j];
      rpe[k] = acc;
    }
    for (int m = lane; m < M; m += kWarpLanes) {
      rpi[m] = ia[m] * x[var[m]] + ib[m] - s[m];
      rc[m] = s[m] * z[m];
      zs[m] = z[m] / s[m];
    }
    __syncwarp();
    assemble(true);
    factor();

    if (M == 0) {
      solve_step(zero, false);
    } else if (sch.mpc) {
      solve_step(zero, false);
      T ap_a, ad_a;
      ftb(one, ap_a, ad_a);
      for (int m = lane; m < M; m += kWarpLanes) ta[m] = (s[m] + ap_a * ds[m]) * (z[m] + ad_a * dz[m]);
      const T mu_aff = nmax(sum_rows() / T(M), zero);
      const T ratio = mu_aff / mu;
      solve_step(ratio * (ratio * ratio) * mu, true);
    } else {
      solve_step(mu, false);
    }

    T ap = one, ad = one;
    if (M > 0) ftb(tau, ap, ad);
    for (int i = lane; i < N; i += kWarpLanes) x[i] = x[i] + ap * sol[i];
    for (int k = lane; k < K; k += kWarpLanes) {
      const T dy = -sol[N + k];
      y[k] = y[k] + ad * dy;
    }
    for (int m = lane; m < M; m += kWarpLanes) {
      s[m] = s[m] + ap * ds[m];
      z[m] = z[m] + ad * dz[m];
      ta[m] = s[m] * z[m];
    }
    if (M > 0) mu = sigma * (sum_rows() / T(M));
    __syncwarp();
  }

  T* __restrict__ xo = static_cast<T*>(t.x) + inst * N;
  for (int i = lane; i < N; i += kWarpLanes) xo[i] = x[i];
  T* __restrict__ yo = static_cast<T*>(t.y) + inst * K;
  for (int k = lane; k < K; k += kWarpLanes) yo[k] = y[k];
}

// Lets `kernel` take `bytes` of dynamic shared memory: 0, a CUDA error code,
// or kTooLarge where the card's opt-in limit is smaller.
template <typename Kernel>
int allow_slab(Kernel kernel, long long bytes) {
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bytes > optin) return kTooLarge;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// A launch of W = warps instances a CTA, or (occupancy_only) the CTAs that
// fit one SM, negative on an error.
template <typename T>
int launch_warp(const Tensors& t, int B, int N, int K, int M, const int* rows, int warps, const Schedule& sch,
                cudaStream_t stream, bool occupancy_only) {
  const long long slab = warp_slab_bytes<T>(N, K, M);
  const long long bytes = slab * warps;
  const int rc = allow_slab(fused_qp_warp_kernel<T>, bytes);
  const int threads = warps * kWarpLanes;
  if (occupancy_only) {
    if (rc != 0) return rc > 0 ? -rc : rc;
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_qp_warp_kernel<T>, threads,
                                                                        static_cast<size_t>(bytes));
    return e == cudaSuccess ? blocks : -static_cast<int>(e);
  }
  if (rc != 0) return rc;
  const long long grid = (static_cast<long long>(B) + warps - 1) / warps;
  fused_qp_warp_kernel<T><<<static_cast<unsigned>(grid), threads, static_cast<size_t>(bytes), stream>>>(
      t, B, N, K, M, rows, slab, sch);
  return static_cast<int>(cudaGetLastError());
}

inline bool warp_shape_ok(int N, int K, int M, int warps) {
  return N >= 1 && K >= 0 && M >= 0 && N + K <= kWarpMaxD && warps >= 1 && warps <= kMaxWarpsPerCta;
}

}  // namespace qp
}  // namespace mo

// The warp route. dtype: 0 float, 1 double. rows: the device table of the
// M box rows (var[M], then ptr[N + 1] and idx[M], the rows of each variable
// in row order); warps: instances a CTA (ops/fused_qp.py::launch_plan).
// The tensors and strides as mo_fused_qp_launch's. kTooLarge where the
// slabs do not fit a CTA.
extern "C" int mo_fused_qp_warp_launch(int dtype, int N, int K, int M, const int* rows, const void* G,
                                       const void* c, const void* A, const void* b, const void* ia,
                                       const void* ib, const long long* strides, void* x, void* y, int B,
                                       int warps, int iterations, double sigma, int mpc, int has_eq_guess,
                                       void* stream) {
  if (B <= 0 || iterations < 0 || !mo::qp::warp_shape_ok(N, K, M, warps) || (M > 0 && rows == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mo::qp::Tensors t{G, c, A, b, ia, ib, x, y, {}, {}, {}, {}, {}, {}};
  long long* dst[] = {t.sG, t.sc, t.sA, t.sb, t.sia, t.sib};
  const int dims[] = {3, 2, 3, 2, 2, 2};
  for (int a = 0, q = 0; a < 6; ++a) {
    for (int d = 0; d < dims[a]; ++d) dst[a][d] = strides[q++];
  }
  const mo::qp::Schedule sch{iterations, sigma, mpc, has_eq_guess};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return mo::qp::launch_warp<float>(t, B, N, K, M, rows, warps, sch, s, false);
    case 1: return mo::qp::launch_warp<double>(t, B, N, K, M, rows, warps, sch, s, false);
    default: return mo::kNoInstance;
  }
}

// CTAs per SM of the warp route at (N, K, M) with `warps` instances a CTA
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); negative on an error.
extern "C" int mo_fused_qp_warp_occupancy(int dtype, int N, int K, int M, int warps) {
  if (!mo::qp::warp_shape_ok(N, K, M, warps)) return -static_cast<int>(cudaErrorInvalidValue);
  const mo::qp::Tensors t{};
  const mo::qp::Schedule sch{0, 0.0, 0, 0};
  switch (dtype) {
    case 0: return mo::qp::launch_warp<float>(t, 1, N, K, M, nullptr, warps, sch, nullptr, true);
    case 1: return mo::qp::launch_warp<double>(t, 1, N, K, M, nullptr, warps, sch, nullptr, true);
    default: return -1;
  }
}

// Bytes of one instance's slab (ops/fused_qp.py::warp_slab_bytes mirrors it).
extern "C" long long mo_fused_qp_warp_slab_bytes(int dtype, int N, int K, int M) {
  return dtype == 0 ? mo::qp::warp_slab_bytes<float>(N, K, M) : mo::qp::warp_slab_bytes<double>(N, K, M);
}
