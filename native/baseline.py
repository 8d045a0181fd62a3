"""ctypes wrapper around the single-core C baseline (native/cv_baseline.c).

Builds the shared library on first use (gcc -O3 -march=native). See the C
file's header for its role: golden-trace generator (reference stand-in;
the real reference mount was empty, SURVEY.md §0) and the single-core
figure for bench.py's >=10x comparison.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_LIB = _DIR / "libcvbaseline.so"
_lib = None


def build(force: bool = False) -> Path:
    if force or not _LIB.exists() or (
            _LIB.stat().st_mtime < (_DIR / "cv_baseline.c").stat().st_mtime):
        subprocess.run(["make", "-C", str(_DIR)], check=True,
                       capture_output=True)
    return _LIB


def _get():
    global _lib
    if _lib is None:
        build()
        _lib = ctypes.CDLL(str(_LIB))
        d = ctypes.POINTER(ctypes.c_double)
        _lib.cv_sweep.argtypes = [d, d, ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_double] * 4
        _lib.cv_region_means.argtypes = [d, d, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_double, d, d]
        _lib.cv_energy.restype = ctypes.c_double
        _lib.cv_energy.argtypes = [d, d, ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_double] * 5
        _lib.cv_segment_fixed.argtypes = [d, d, ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_double] * 7 + [ctypes.c_int, d, d, d]
        _lib.cv_bench_loop.argtypes = [d, d, ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_double] * 7 + [ctypes.c_int, d]
    return _lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def sweep(phi, f, mu, dt, eps, eta2):
    """One in-place raster GS sweep; returns the modified copy."""
    lib = _get()
    phi = np.ascontiguousarray(phi, np.float64).copy()
    f = np.ascontiguousarray(f, np.float64)
    H, W = phi.shape
    lib.cv_sweep(_ptr(phi), _ptr(f), H, W, mu, dt, eps, eta2)
    return phi


def region_means(u0, phi, eps):
    lib = _get()
    u0 = np.ascontiguousarray(u0, np.float64)
    phi = np.ascontiguousarray(phi, np.float64)
    c1 = ctypes.c_double()
    c2 = ctypes.c_double()
    lib.cv_region_means(_ptr(u0), _ptr(phi), phi.shape[0], phi.shape[1],
                        eps, ctypes.byref(c1), ctypes.byref(c2))
    return c1.value, c2.value


def energy(u0, phi, mu, nu, l1, l2, eps):
    lib = _get()
    u0 = np.ascontiguousarray(u0, np.float64)
    phi = np.ascontiguousarray(phi, np.float64)
    return lib.cv_energy(_ptr(u0), _ptr(phi), phi.shape[0], phi.shape[1],
                         mu, nu, l1, l2, eps)


def segment_fixed(u0, p, iters, phi0, want_energy=True, want_delta=True):
    """Fixed-iteration run; returns (phi, energy_trace, delta_trace)."""
    lib = _get()
    u0 = np.ascontiguousarray(u0, np.float64)
    phi = np.ascontiguousarray(phi0, np.float64).copy()
    H, W = phi.shape
    e = np.zeros(iters) if want_energy else None
    dl = np.zeros(iters) if want_delta else None
    f = np.zeros((H, W))
    lib.cv_segment_fixed(
        _ptr(phi), _ptr(u0), H, W, p.mu, p.nu, p.lambda1, p.lambda2,
        p.dt, p.eps, p.eta2, iters,
        _ptr(e) if want_energy else None,
        _ptr(dl) if want_delta else None, _ptr(f))
    return phi, e, dl


def bench_mpixel_iters_per_sec(h=512, w=512, iters=20, p=None, repeats=3):
    """Measured single-core throughput of the canonical C scheme."""
    import time

    from chan_vese.params import CVParams
    from chan_vese.utils.init_phi import checkerboard

    p = p or CVParams()
    rng = np.random.default_rng(0)
    u0 = np.ascontiguousarray(rng.uniform(0, 255, size=(h, w)))
    phi0 = np.asarray(checkerboard((h, w))).astype(np.float64)
    lib = _get()
    f = np.zeros((h, w))
    best = float("inf")
    for _ in range(repeats):
        phi = phi0.copy()
        t0 = time.perf_counter()
        lib.cv_bench_loop(_ptr(phi), _ptr(u0), h, w, p.mu, p.nu, p.lambda1,
                          p.lambda2, p.dt, p.eps, p.eta2, iters, _ptr(f))
        best = min(best, time.perf_counter() - t0)
    return (h * w * iters) / best / 1e6
