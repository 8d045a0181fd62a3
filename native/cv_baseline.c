/* Single-core C baseline of the Chan-Vese semi-implicit raster
 * Gauss-Seidel scheme (Chan & Vese 2001 §4; Getreuer IPOL 2012 lineage).
 *
 * Role in this repo (SURVEY.md §4.5, §7): the reference checkout at
 * /root/reference was EMPTY (SURVEY.md §0), so this file is the project's
 * own transcription of the published scheme the reference implements. It
 * serves as (a) the golden-trace generator for energy-trace parity tests
 * (BASELINE.json:5: <=1e-5 at fixed iteration count) and (b) the measured
 * single-core CPU figure for the ">=10x single-core C++ throughput per
 * chip" comparison in bench.py.
 *
 * Conventions are shared bit-for-bit (in exact arithmetic) with
 * chan_vese/ops/sweep_np.py (NumPy) and ops/sweep.py::wavefront_step
 * (JAX): replica-eval Neumann boundaries (out-of-range differences vanish,
 * including inside the backward face coefficients), H_2/delta_2
 * regularization, raster in-place sweep, energy evaluated after each sweep
 * with region means recomputed from the post-sweep phi.
 *
 * Build: make (gcc -O3 -march=native -shared). Used via ctypes from
 * native/baseline.py.
 */

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define CLAMP(v, lo, hi) ((v) < (lo) ? (lo) : ((v) > (hi) ? (hi) : (v)))

static inline double at(const double *phi, int H, int W, int i, int j) {
    i = CLAMP(i, 0, H - 1);
    j = CLAMP(j, 0, W - 1);
    return phi[(size_t)i * W + j];
}

/* Face coefficients, replica-eval boundary convention (shared with
 * chan_vese/ops/numerics.py): every VALUE read clamps to the grid, so
 * out-of-range differences vanish - including inside the backward
 * coefficients A- (amcoef) and B- (bmcoef). */
static inline double acoef(const double *phi, int H, int W, int i, int j,
                           double mu, double eta2) {
    double dxp = at(phi, H, W, i + 1, j) - at(phi, H, W, i, j);
    double dy0 = 0.5 * (at(phi, H, W, i, j + 1) - at(phi, H, W, i, j - 1));
    return mu / sqrt(eta2 + dxp * dxp + dy0 * dy0);
}

static inline double amcoef(const double *phi, int H, int W, int i, int j,
                            double mu, double eta2) {
    double dxm = at(phi, H, W, i, j) - at(phi, H, W, i - 1, j);
    double dy0m = 0.5 * (at(phi, H, W, i - 1, j + 1)
                         - at(phi, H, W, i - 1, j - 1));
    return mu / sqrt(eta2 + dxm * dxm + dy0m * dy0m);
}

static inline double bcoef(const double *phi, int H, int W, int i, int j,
                           double mu, double eta2) {
    double dx0 = 0.5 * (at(phi, H, W, i + 1, j) - at(phi, H, W, i - 1, j));
    double dyp = at(phi, H, W, i, j + 1) - at(phi, H, W, i, j);
    return mu / sqrt(eta2 + dx0 * dx0 + dyp * dyp);
}

static inline double bmcoef(const double *phi, int H, int W, int i, int j,
                            double mu, double eta2) {
    double dym = at(phi, H, W, i, j) - at(phi, H, W, i, j - 1);
    double dx0m = 0.5 * (at(phi, H, W, i + 1, j - 1)
                         - at(phi, H, W, i - 1, j - 1));
    return mu / sqrt(eta2 + dx0m * dx0m + dym * dym);
}

/* The shared per-cell semi-implicit update (the scheme of SURVEY.md §3.1;
 * single definition so the plain sweep and the flip-counting sweep cannot
 * drift apart). */
static inline double cv_cell_update(const double *phi, const double *f,
                                    int H, int W, int i, int j, double mu,
                                    double dt, double eps, double eta2) {
    double A  = acoef(phi, H, W, i, j, mu, eta2);
    double Am = amcoef(phi, H, W, i, j, mu, eta2);
    double B  = bcoef(phi, H, W, i, j, mu, eta2);
    double Bm = bmcoef(phi, H, W, i, j, mu, eta2);
    double z = phi[(size_t)i * W + j];
    double d = (eps / M_PI) / (eps * eps + z * z);
    double num = z + dt * d * (A * at(phi, H, W, i + 1, j)
                               + Am * at(phi, H, W, i - 1, j)
                               + B * at(phi, H, W, i, j + 1)
                               + Bm * at(phi, H, W, i, j - 1)
                               + f[(size_t)i * W + j]);
    double den = 1.0 + dt * d * (A + Am + B + Bm);
    return num / den;
}

/* One in-place raster Gauss-Seidel sweep with a precomputed data term f. */
void cv_sweep(double *phi, const double *f, int H, int W, double mu,
              double dt, double eps, double eta2) {
    for (int i = 0; i < H; ++i)
        for (int j = 0; j < W; ++j)
            phi[(size_t)i * W + j] =
                cv_cell_update(phi, f, H, W, i, j, mu, dt, eps, eta2);
}

/* Region means c1 (H_eps-weighted) and c2. */
void cv_region_means(const double *u0, const double *phi, int H, int W,
                     double eps, double *c1, double *c2) {
    double sum_uh = 0.0, sum_h = 0.0, sum_u = 0.0;
    size_t n = (size_t)H * W;
    for (size_t k = 0; k < n; ++k) {
        double h = 0.5 * (1.0 + (2.0 / M_PI) * atan(phi[k] / eps));
        sum_uh += u0[k] * h;
        sum_h += h;
        sum_u += u0[k];
    }
    double tiny = 1e-30;
    *c1 = sum_uh / (sum_h > tiny ? sum_h : tiny);
    double rest = (double)n - sum_h;
    *c2 = (sum_u - sum_uh) / (rest > tiny ? rest : tiny);
}

/* Chan-Vese energy with forward differences (clamped last row/col). */
double cv_energy(const double *u0, const double *phi, int H, int W,
                 double mu, double nu, double l1, double l2, double eps) {
    double length = 0.0, area = 0.0, fit1 = 0.0, fit2 = 0.0;
    double c1, c2;
    cv_region_means(u0, phi, H, W, eps, &c1, &c2);
    for (int i = 0; i < H; ++i) {
        for (int j = 0; j < W; ++j) {
            double z = phi[(size_t)i * W + j];
            double h = 0.5 * (1.0 + (2.0 / M_PI) * atan(z / eps));
            double d = (eps / M_PI) / (eps * eps + z * z);
            double gx = at(phi, H, W, i + 1, j) - z;
            double gy = at(phi, H, W, i, j + 1) - z;
            length += d * sqrt(gx * gx + gy * gy);
            area += h;
            double u = u0[(size_t)i * W + j];
            fit1 += (u - c1) * (u - c1) * h;
            fit2 += (u - c2) * (u - c2) * (1.0 - h);
        }
    }
    return mu * length + nu * area + l1 * fit1 + l2 * fit2;
}

/* Full fixed-iteration segmentation; phi updated in place.
 * energy_out (len iters) records the post-sweep energy each iteration
 * (means recomputed from the post-sweep phi - the parity convention).
 * delta_out (len iters) records the mask-flip fraction per iteration.
 * Pass NULL for either to skip. Scratch f must hold H*W doubles. */
void cv_segment_fixed(double *phi, const double *u0, int H, int W,
                      double mu, double nu, double l1, double l2,
                      double dt, double eps, double eta2, int iters,
                      double *energy_out, double *delta_out, double *f) {
    size_t n = (size_t)H * W;
    for (int it = 0; it < iters; ++it) {
        double c1, c2;
        cv_region_means(u0, phi, H, W, eps, &c1, &c2);
        for (size_t k = 0; k < n; ++k) {
            double du1 = u0[k] - c1, du2 = u0[k] - c2;
            f[k] = -nu - l1 * du1 * du1 + l2 * du2 * du2;
        }
        long flips = 0;
        if (delta_out) {
            /* sweep with flip counting (same cv_cell_update) */
            for (int i = 0; i < H; ++i) {
                for (int j = 0; j < W; ++j) {
                    double z = phi[(size_t)i * W + j];
                    double newz = cv_cell_update(phi, f, H, W, i, j, mu,
                                                 dt, eps, eta2);
                    flips += ((newz >= 0.0) != (z >= 0.0));
                    phi[(size_t)i * W + j] = newz;
                }
            }
            delta_out[it] = (double)flips / (double)n;
        } else {
            cv_sweep(phi, f, H, W, mu, dt, eps, eta2);
        }
        if (energy_out)
            energy_out[it] = cv_energy(u0, phi, H, W, mu, nu, l1, l2, eps);
    }
}

/* Throughput kernel for benchmarking: iters sweeps with means+data term
 * recomputed each iteration but NO energy logging (the hot-loop work a
 * production run does). Returns nothing; time it from Python. */
void cv_bench_loop(double *phi, const double *u0, int H, int W, double mu,
                   double nu, double l1, double l2, double dt, double eps,
                   double eta2, int iters, double *f) {
    cv_segment_fixed(phi, u0, H, W, mu, nu, l1, l2, dt, eps, eta2, iters,
                     NULL, NULL, f);
}
