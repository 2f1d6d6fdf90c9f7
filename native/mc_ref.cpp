// Independent reference Monte Carlo solver (CPU, C++17).
//
// Role: the cross-validation counterpart that MCARaTS plays for the
// reference toolbox (examples/00_er3t_bmk.py cross-checks two independent
// solvers).  This is a deliberately straightforward serial implementation —
// per-photon event loop, layer marching with null-collision sampling in the
// 3D region — sharing no code or structure with the JAX kernels, so that
// agreement between the two is meaningful.
//
// Physics: plane-parallel layered atmosphere (Rayleigh scattering + per-g
// gas absorption carried as correlated weights) with an optional 3D
// particulate region (per-voxel extinction / single-scattering albedo /
// tabulated phase row), Lambertian surface, collimated solar source.
// Outputs: nadir radiance image by local estimation and domain-average
// level fluxes (down-direct / down-diffuse / up).
//
// Exposed with a C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    // splitmix64
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  double u() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double u_open() {
    double v = u();
    return v < 1e-12 ? 1e-12 : (v > 1.0 - 1e-12 ? 1.0 - 1e-12 : v);
  }
};

struct Scene {
  int nz, ng, nx, ny, nz3, iz3l, npf, nu, nm;
  const double* z_lev;     // nz+1
  const double* sig_ray;   // nz
  const double* sig_aer;   // nz
  const double* kabs;      // nz*ng
  const double* sig_maj;   // nz
  const double* ext3d;     // nx*ny*nz3
  const double* ssa3d;
  const int* apf3d;
  const double* pt_mu;     // npf*nu
  const double* pt_p;      // npf*nm
  double dx, dy, albedo, mu0, phi0;
};

// ``first``: first-order (still-direct) local estimates read the TMS rows
// (second half of pt_p, P_full/(1-f)) so single scattering stays exact
// under delta-truncated tables — the same Nakajima & Tanaka (1988)
// estimator definition as the JAX flight kernel (pre/pha.py p_tms).
// Rayleigh (apf == 0) is analytic and truncation-free either way.
inline double phase_eval(const Scene& sc, int apf, double mu, bool first) {
  if (apf == 0) return 0.75 * (1.0 + mu * mu);
  double fm = (mu + 1.0) * 0.5 * (sc.nm - 1);
  int i = (int)(fm + 0.5);
  if (i < 0) i = 0;
  if (i >= sc.nm) i = sc.nm - 1;
  int row = first ? apf + sc.npf : apf;
  return sc.pt_p[row * sc.nm + i];
}

inline double phase_sample(const Scene& sc, int apf, double u, Rng& rng) {
  if (apf == 0) {
    // analytic Rayleigh inverse CDF
    double v = 2.0 * u - 1.0;
    double q = 2.0 * v + std::sqrt(4.0 * v * v + 1.0);
    double qc = std::cbrt(q);
    return qc - 1.0 / qc;
  }
  double fu = u * (sc.nu - 1);
  int i = (int)(fu + 0.5);
  if (i < 0) i = 0;
  if (i >= sc.nu) i = sc.nu - 1;
  return sc.pt_mu[apf * sc.nu + i];
}

inline void rotate(double mu, double psi, double& ux, double& uy, double& uz) {
  double st = std::sqrt(std::fmax(1.0 - mu * mu, 0.0));
  double cp = std::cos(psi), sp = std::sin(psi);
  if (std::fabs(uz) > 0.99999) {
    double sgn = uz > 0 ? 1.0 : -1.0;
    ux = st * cp;
    uy = st * sp;
    uz = mu * sgn;
  } else {
    double den = std::sqrt(1.0 - uz * uz);
    double nx = st * (ux * uz * cp - uy * sp) / den + ux * mu;
    double ny = st * (uy * uz * cp + ux * sp) / den + uy * mu;
    double nz = -st * cp * den + uz * mu;
    ux = nx; uy = ny; uz = nz;
  }
  double n = 1.0 / std::sqrt(ux * ux + uy * uy + uz * uz);
  ux *= n; uy *= n; uz *= n;
}

}  // namespace

extern "C" {

// out_rad: nx*ny*ng, out_flux: (nz+1)*3*ng
void mc_ref_run(
    int nz, int ng, int nx, int ny, int nz3, int iz3l,
    int npf, int nu, int nm,
    const double* z_lev, const double* sig_ray, const double* sig_aer,
    const double* kabs, const double* sig_maj,
    const double* ext3d, const double* ssa3d, const int* apf3d,
    const double* pt_mu, const double* pt_p,
    double dx, double dy, double albedo, double sza_deg, double saa_deg,
    long long n_photon, uint64_t seed, int do_radiance,
    double rr_wmin, double* out_rad, double* out_flux) {
  Scene sc{nz, ng, nx, ny, nz3, iz3l, npf, nu, nm,
           z_lev, sig_ray, sig_aer, kabs, sig_maj, ext3d, ssa3d, apf3d,
           pt_mu, pt_p, dx, dy, albedo,
           std::cos(sza_deg * M_PI / 180.0), (270.0 - saa_deg) * M_PI / 180.0};
  const double lx = nx * dx, ly = ny * dy;
  const double z_top = z_lev[nz];
  std::vector<double> cum_abs_lev((nz + 1) * ng, 0.0),
      cum_sig_lev(nz + 1, 0.0);
  std::vector<double> cum3d;  // per-column ext above level k (nz3+1)
  if (nz3 > 0) {
    cum3d.assign((size_t)nx * ny * (nz3 + 1), 0.0);
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < ny; ++j)
        for (int k = nz3 - 1; k >= 0; --k) {
          double dzk = z_lev[iz3l + k + 1] - z_lev[iz3l + k];
          size_t base = ((size_t)i * ny + j) * (nz3 + 1);
          cum3d[base + k] = cum3d[base + k + 1] +
                            ext3d[((size_t)i * ny + j) * nz3 + k] * dzk;
        }
  }
  for (int l = nz - 1; l >= 0; --l) {
    double dz = z_lev[l + 1] - z_lev[l];
    cum_sig_lev[l] = cum_sig_lev[l + 1] + (sig_ray[l] + sig_aer[l]) * dz;
    for (int g = 0; g < ng; ++g)
      cum_abs_lev[l * ng + g] = cum_abs_lev[(l + 1) * ng + g] + kabs[l * ng + g] * dz;
  }

  auto vox = [&](double x, double y, int l) -> size_t {
    int i = (int)std::floor(x / dx); i = ((i % nx) + nx) % nx;
    int j = (int)std::floor(y / dy); j = ((j % ny) + ny) % ny;
    return ((size_t)i * ny + j) * nz3 + (l - iz3l);
  };

  double sin0 = std::sqrt(std::fmax(1.0 - sc.mu0 * sc.mu0, 0.0));

  // OpenMP photon-parallel: per-photon counter-seeded RNG streams make the
  // result independent of the thread count; per-thread tally buffers are
  // reduced at the end (same fan-out role as the reference's mp.Pool).
  int nth = 1;
#ifdef _OPENMP
  nth = omp_get_max_threads();
#endif
  std::vector<std::vector<double>> rad_acc((size_t)nth),
      flux_acc((size_t)nth);
  for (int t = 0; t < nth; ++t) {
    rad_acc[t].assign((size_t)nx * ny * ng, 0.0);
    flux_acc[t].assign((size_t)(nz + 1) * 3 * ng, 0.0);
  }

#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    int tid = 0;
#ifdef _OPENMP
    tid = omp_get_thread_num();
#endif
    double* orad = rad_acc[tid].data();
    double* oflux = flux_acc[tid].data();
    std::vector<double> w(ng);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 4096)
#endif
  for (long long p = 0; p < n_photon; ++p) {
    Rng rng(seed + 0x9e3779b97f4a7c15ull * (uint64_t)(p + 1));
    double x = rng.u() * lx, y = rng.u() * ly, z = z_top;
    double ux = sin0 * std::cos(sc.phi0), uy = sin0 * std::sin(sc.phi0),
           uz = -sc.mu0;
    int l = nz - 1;
    for (int g = 0; g < ng; ++g) w[g] = 1.0;
    double wsc = 1.0;
    bool direct = true, alive = true;
    // TOA entry crossing
    for (int g = 0; g < ng; ++g) oflux[(nz * 3 + 0) * ng + g] += 1.0;
    double tau = -std::log(rng.u_open());
    int guard = 0;
    while (alive && ++guard < 1000000) {
      double sm = sig_maj[l];
      double s_col = tau / sm;
      double zb = uz > 0 ? z_lev[l + 1] : z_lev[l];
      double uzs = std::fabs(uz) < 1e-9 ? (uz >= 0 ? 1e-9 : -1e-9) : uz;
      double s_b = (zb - z) / uzs;
      if (s_b < 0) s_b = 0;
      bool is_col = s_col < s_b;
      double s = is_col ? s_col : s_b;
      // gas absorption along s
      for (int g = 0; g < ng; ++g) w[g] *= std::exp(-kabs[l * ng + g] * s);
      x = std::fmod(x + ux * s + 64.0 * lx, lx);
      y = std::fmod(y + uy * s + 64.0 * ly, ly);
      z += uz * s;
      if (is_col) {
        bool in3 = nz3 > 0 && l >= iz3l && l < iz3l + nz3;
        double ec = in3 ? ext3d[vox(x, y, l)] : 0.0;
        double sr = sig_ray[l], sa = sig_aer[l];
        double sreal = sr + sa + ec;
        if (rng.u() * sm < sreal) {
          // real collision: channel select
          double pick = rng.u() * sreal;
          int apf = 0;
          double ssa_ev = 1.0;
          if (pick < sr) {
            apf = 0;
          } else if (pick < sr + sa) {
            apf = npf - 1;
          } else {
            size_t v = vox(x, y, l);
            apf = apf3d[v];
            ssa_ev = ssa3d[v];
          }
          if (do_radiance) {
            // local estimate to nadir sensor
            double mu_sc = uz;  // dot(u, up)
            double pv = phase_eval(sc, apf, mu_sc, direct);
            double t_sig = cum_sig_lev[l + 1] + (sig_ray[l] + sig_aer[l]) * (z_lev[l + 1] - z);
            double t3 = 0.0;
            if (nz3 > 0) {
              if (l < iz3l) {
                t3 = cum3d[(vox(x, y, iz3l) / nz3) * (nz3 + 1)];
              } else if (l < iz3l + nz3) {
                size_t col = vox(x, y, l) / nz3;
                int k = l - iz3l;
                t3 = cum3d[col * (nz3 + 1) + k + 1] +
                     ext3d[col * nz3 + k] * (z_lev[l + 1] - z);
              }
            }
            int pi = (int)std::floor(x / dx); pi = ((pi % nx) + nx) % nx;
            int pj = (int)std::floor(y / dy); pj = ((pj % ny) + ny) % ny;
            double base = wsc * ssa_ev * pv / (4.0 * M_PI);
            for (int g = 0; g < ng; ++g) {
              double t_abs = cum_abs_lev[(l + 1) * ng + g] +
                             kabs[l * ng + g] * (z_lev[l + 1] - z);
              orad[((size_t)pi * ny + pj) * ng + g] +=
                  base * w[g] * std::exp(-(t_sig + t3 + t_abs));
            }
          }
          wsc *= ssa_ev;
          double mu = phase_sample(sc, apf, rng.u_open(), rng);
          rotate(mu, rng.u() * 2.0 * M_PI, ux, uy, uz);
          direct = false;
        }
        tau = -std::log(rng.u_open());
      } else {
        tau -= sm * s;
        int lev, ch;
        if (uz > 0) { lev = l + 1; ch = 2; l += 1; }
        else { lev = l; ch = direct ? 0 : 1; l -= 1; }
        for (int g = 0; g < ng; ++g)
          oflux[((size_t)lev * 3 + ch) * ng + g] += wsc * w[g];
        if (l < 0) {
          // surface
          if (do_radiance) {
            int pi = (int)std::floor(x / dx); pi = ((pi % nx) + nx) % nx;
            int pj = (int)std::floor(y / dy); pj = ((pj % ny) + ny) % ny;
            double t3 = nz3 > 0 ? cum3d[((size_t)pi * ny + pj) * (nz3 + 1)] : 0.0;
            double base = wsc * albedo / M_PI;
            for (int g = 0; g < ng; ++g)
              orad[((size_t)pi * ny + pj) * ng + g] +=
                  base * w[g] * std::exp(-(cum_sig_lev[0] + t3 + cum_abs_lev[g]));
          }
          wsc *= albedo;
          direct = false;
          double mu_r = std::sqrt(rng.u_open());
          double psi = rng.u() * 2.0 * M_PI;
          double sr2 = std::sqrt(std::fmax(1.0 - mu_r * mu_r, 0.0));
          ux = sr2 * std::cos(psi); uy = sr2 * std::sin(psi); uz = mu_r;
          z = 0.0; l = 0;
          tau = -std::log(rng.u_open());
          // upward crossing AT the surface level with the reflected
          // weight: the next marching step would first tally level 1,
          // silently dropping the surface up-flux (same fix as the JAX
          // kernels, round 4)
          for (int g = 0; g < ng; ++g)
            oflux[(0 * 3 + 2) * ng + g] += wsc * w[g];
        } else if (l >= nz) {
          alive = false;
        }
      }
      // Russian roulette on the best-case weight
      double wbest = 0.0;
      for (int g = 0; g < ng; ++g) wbest = std::fmax(wbest, w[g]);
      wbest *= wsc;
      if (alive && wbest < rr_wmin) {
        double psur = wbest / rr_wmin;
        if (rng.u() > psur) alive = false;
        else wsc /= psur;
      }
    }
  }
  }  // omp parallel

  for (int t = 0; t < nth; ++t) {
    for (size_t i = 0; i < (size_t)nx * ny * ng; ++i)
      out_rad[i] += rad_acc[t][i];
    for (size_t i = 0; i < (size_t)(nz + 1) * 3 * ng; ++i)
      out_flux[i] += flux_acc[t][i];
  }
}

}  // extern "C"
