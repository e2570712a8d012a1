// Native CPU oracle stepper.
//
// Exact C++ mirror of sph_pie_tpu/oracle.py (which itself mirrors the JAX
// engines term for term): dense O(N^2) pairs, float64, OpenMP-parallel over
// particles. Purpose: make the BASELINE trajectory contract (2D ~4k
// particles, 1000 steps vs the CPU reference) run in seconds — the NumPy
// oracle needs minutes at that size. Summation order over j matches the
// NumPy axis-1 reduction (ascending j), so agreement is ~1e-12.
//
// Built by sph_pie_tpu/native/__init__.py via g++ -O3 -fopenmp; the Python
// oracle remains the always-available fallback.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct Params {
  // layout must match native/__init__.py PARAMS_LAYOUT
  double h, dt, rho0, c0, mu, xsph_eps, st, gamma_, B, vcap, bk, bc;
  double gravity[3];
  double bmin[3];
  double bmax[3];
};

inline double ipow(double x, int n) {
  double r = 1.0;
  for (int i = 0; i < n; ++i) r *= x;
  return r;
}

}  // namespace

extern "C" void sph_oracle_run(int dim, int n, int steps, double* pos,
                               double* vel, const double* mass,
                               const double* params_raw) {
  Params P;
  std::memcpy(&P, params_raw, sizeof(Params));
  const double h = P.h, h2 = h * h;
  const int gamma_i = static_cast<int>(P.gamma_);
  const double poly6_c =
      dim == 2 ? 4.0 / (kPi * ipow(h, 8)) : 315.0 / (64.0 * kPi * ipow(h, 9));
  const double spiky_c =
      dim == 2 ? -30.0 / (kPi * ipow(h, 5)) : -45.0 / (kPi * ipow(h, 6));
  const double visc_c =
      dim == 2 ? 40.0 / (kPi * ipow(h, 5)) : 45.0 / (kPi * ipow(h, 6));
  const double coh_k = 32.0 / (kPi * ipow(h, dim == 3 ? 9 : 8));
  const double h6_64 = ipow(h, 6) / 64.0;
  const bool use_coh = P.st != 0.0;
  const bool use_xsph = P.xsph_eps != 0.0;

  std::vector<double> rho(n), prs(n), acc(n * dim), xsph(n * dim);

  for (int s = 0; s < steps; ++s) {
    // --- density (self term included) + floor ---
#pragma omp parallel for schedule(static)
    for (int i = 0; i < n; ++i) {
      double sum = 0.0;
      const double* pi = pos + i * dim;
      for (int j = 0; j < n; ++j) {
        double r2 = 0.0;
        const double* pj = pos + j * dim;
        for (int k = 0; k < dim; ++k) {
          const double d = pi[k] - pj[k];
          r2 += d * d;
        }
        const double q = h2 - r2;
        if (q > 0.0) sum += mass[j] * poly6_c * q * q * q;
      }
      rho[i] = std::max(sum, 1e-6 * P.rho0);
      prs[i] = std::max(P.B * (ipow(rho[i] / P.rho0, gamma_i) - 1.0), 0.0);
    }

    // --- pair forces ---
#pragma omp parallel for schedule(static)
    for (int i = 0; i < n; ++i) {
      double a[3] = {0, 0, 0};
      double xs[3] = {0, 0, 0};
      const double* pi = pos + i * dim;
      const double* vi = vel + i * dim;
      const double pr_i = prs[i] / (rho[i] * rho[i]);
      for (int j = 0; j < n; ++j) {
        const double* pj = pos + j * dim;
        double d[3], r2 = 0.0;
        for (int k = 0; k < dim; ++k) {
          d[k] = pi[k] - pj[k];
          r2 += d[k] * d[k];
        }
        if (!(r2 < h2 && r2 > 1e-12)) continue;
        const double r = std::sqrt(r2);
        const double inv_r = 1.0 / r;
        const double m_j = mass[j];
        const double hr = h - r;
        // pressure (symmetric) + cohesion share the radial direction
        const double gw = spiky_c * hr * hr;
        double radial = m_j * (pr_i + prs[j] / (rho[j] * rho[j])) * gw;
        if (use_coh) {
          const double hr3r3 = hr * hr * hr * r2 * r;
          const double c =
              (r <= 0.5 * h) ? (2.0 * hr3r3 - h6_64) : hr3r3;
          radial += P.st * m_j * coh_k * c;
        }
        radial *= inv_r;
        const double lap = visc_c * hr;
        const double vw = (P.mu / rho[i]) * m_j / rho[j] * lap;
        const double* vj = vel + j * dim;
        double xw = 0.0;
        if (use_xsph) {
          // m_j/rho_j weighting (mirrors solvers/wcsph.py pair loop)
          const double q = h2 - r2;
          xw = m_j / rho[j] * poly6_c * q * q * q;
        }
        for (int k = 0; k < dim; ++k) {
          const double dv = vj[k] - vi[k];
          a[k] += -radial * d[k] + vw * dv;
          xs[k] += xw * dv;
        }
      }
      // gravity + boundary penalty (damping ramps over 0.1h of
      // penetration; mirrors solvers/wcsph.py boundary_accel exactly)
      double bacc[3] = {0, 0, 0};
      double pen = 0.0;
      for (int k = 0; k < dim; ++k) {
        const double lo = std::max(P.bmin[k] - pi[k], 0.0);
        const double hi = std::max(pi[k] - P.bmax[k], 0.0);
        bacc[k] = P.bk * (lo - hi);
        pen = std::max(pen, lo + hi);
      }
      const double ramp = std::min(pen / (0.1 * h), 1.0);
      for (int k = 0; k < dim; ++k) {
        a[k] += P.gravity[k] + bacc[k] - P.bc * ramp * vi[k];
        acc[i * dim + k] = a[k];
        xsph[i * dim + k] = xs[k];
      }
    }

    // --- symplectic Euler + CFL clamp + XSPH advection ---
#pragma omp parallel for schedule(static)
    for (int i = 0; i < n; ++i) {
      double speed2 = 0.0;
      double v[3];
      for (int k = 0; k < dim; ++k) {
        v[k] = vel[i * dim + k] + P.dt * acc[i * dim + k];
        speed2 += v[k] * v[k];
      }
      const double scale =
          speed2 > P.vcap * P.vcap ? P.vcap / std::sqrt(speed2) : 1.0;
      for (int k = 0; k < dim; ++k) {
        vel[i * dim + k] = v[k] * scale;
        pos[i * dim + k] +=
            P.dt * (vel[i * dim + k] + P.xsph_eps * xsph[i * dim + k]);
      }
    }
  }
}
