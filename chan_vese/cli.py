"""Command-line interface (SURVEY.md C15, L5).

Mirrors the reference CLI's parameter surface exactly (BASELINE.json:5:
mu, nu, lambda1, lambda2, dt, eps, per-pixel tolerance, max-iter, init,
I/O paths, grayscale/color switch) plus the rebuild's additions: multiphase,
morphological and pyramid drivers, sweep-order selection, sharded meshes,
energy-trace CSV, evolution GIF, pre-smoothing, reinit cadence.

    python -m chan_vese input.png -o mask.png --mu 650.25 --tol 1e-5
    python -m chan_vese input.png --color --lambda1 1 1.2 0.8
    python -m chan_vese input.png --multiphase 2 -o labels.png
    python -m chan_vese input.png --trace-energy trace.csv --iters 100
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .params import CVParams


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="chan_vese",
        description="Chan-Vese active-contour segmentation (JAX/XLA)")
    ap.add_argument("input", help="input image (png/jpg/npy)")
    ap.add_argument("-o", "--output", default=None,
                    help="output mask / label map (png/npy)")
    ap.add_argument("--overlay", default=None,
                    help="write a contour overlay image here")
    d = CVParams()
    ap.add_argument("--mu", type=float, default=d.mu,
                    help=f"length penalty (default {d.mu:g}; for [0,255] "
                         "intensities - the loader keeps that range)")
    ap.add_argument("--nu", type=float, default=d.nu, help="area penalty")
    ap.add_argument("--lambda1", type=float, nargs="+", default=[d.lambda1],
                    help="inside fit weight(s); one per channel with --color")
    ap.add_argument("--lambda2", type=float, nargs="+", default=[d.lambda2],
                    help="outside fit weight(s)")
    ap.add_argument("--dt", type=float, default=d.dt, help="time step")
    ap.add_argument("--eps", type=float, default=d.eps,
                    help="Heaviside/Dirac regularization width")
    ap.add_argument("--tol", type=float, default=d.tol,
                    help="per-pixel convergence tolerance (see --conv)")
    ap.add_argument("--max-iter", type=int, default=d.max_iter)
    ap.add_argument("--iters", type=int, default=None,
                    help="run EXACTLY this many iterations (fixed mode, "
                         "enables --trace-energy)")
    ap.add_argument("--conv", choices=("flips", "rms", "mean_abs"),
                    default=d.conv_norm, help="convergence metric")
    ap.add_argument("--init", default=d.init,
                    choices=("checkerboard", "circle", "rect", "disk",
                             "small-disk"))
    ap.add_argument("--order", choices=("redblack", "jacobi", "wavefront"),
                    default=d.order,
                    help="sweep ordering (wavefront == sequential raster "
                         "Gauss-Seidel; parity mode)")
    ap.add_argument("--color", action="store_true",
                    help="vector-valued (RGB) energy on color images")
    ap.add_argument("--pyramid", type=int, default=0, metavar="L",
                    help="coarse-to-fine multiscale: segment an L-times "
                         "2x-decimated copy first and refine upward "
                         "(tolerance mode, single chip; -1 = auto depth)")
    ap.add_argument("--multiphase", type=int, default=0, metavar="M",
                    help="use M coupled level sets (2^M phases)")
    ap.add_argument("--morph", action="store_true",
                    help="morphological Chan-Vese (MorphACWE): binary "
                         "level set with sup-inf/inf-sup curvature "
                         "smoothing instead of the PDE - unconditionally "
                         "stable, ~10 elementwise passes per iteration; "
                         "gray or --color; --mu/--dt/--eps unused")
    ap.add_argument("--morph-smoothing", type=int, default=1, metavar="S",
                    help="SI/IS smoothing cycles per --morph iteration")
    ap.add_argument("--morph-gac", action="store_true",
                    help="morphological geodesic active contours "
                         "(MorphGAC): segments the inverse-Gaussian-"
                         "gradient edge map of the image with balloon + "
                         "edge-attraction forces and the morphological "
                         "smoothing; use --balloon/--gac-* to steer; "
                         "--init disk seeds the contour")
    ap.add_argument("--balloon", type=int, default=0, metavar="B",
                    help="MorphGAC balloon force: +1 grow, -1 shrink, "
                         "0 off")
    ap.add_argument("--gac-alpha", type=float, default=100.0,
                    help="inverse-Gaussian-gradient steepness")
    ap.add_argument("--gac-sigma", type=float, default=5.0,
                    help="inverse-Gaussian-gradient blur width")
    ap.add_argument("--gac-threshold", default="auto",
                    help="balloon activation threshold on the edge map "
                         "('auto' = 40th percentile)")
    ap.add_argument("--smooth", type=int, default=0, metavar="STEPS",
                    help="Perona-Malik pre-smoothing steps")
    ap.add_argument("--smooth-kappa", type=float, default=10.0)
    ap.add_argument("--reinit-every", type=int, default=d.reinit_every)
    ap.add_argument("--trace-energy", default=None, metavar="CSV",
                    help="write the per-iteration energy trace (fixed mode)")
    ap.add_argument("--evolution-gif", default=None, metavar="GIF",
                    help="write a contour-evolution animation (fixed mode, "
                         "records every --gif-every iterations)")
    ap.add_argument("--gif-every", type=int, default=5)
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("NX", "NY"),
                    help="shard the image over an NX x NY device mesh "
                         "(spatial sharding with collective halo "
                         "exchange)")
    ap.add_argument("--halo", choices=("ppermute", "overlap"),
                    default="ppermute",
                    help="sharded halo schedule: exchange then sweep "
                         "(default), or comm/compute overlap (interior "
                         "compute concurrent with the exchange; composes "
                         "with --comm-k)")
    ap.add_argument("--comm-k", type=int, default=1, metavar="K",
                    help="sharded communication-avoiding chunking: one "
                         "4K-deep halo exchange per K iterations "
                         "(frozen-means trajectory class; grayscale and "
                         "--color)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write .npz checkpoints here every "
                         "--checkpoint-every iterations (fixed mode); "
                         "resumes from the newest checkpoint if present")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--f64", action="store_true",
                    help="double precision (CPU parity mode)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from .models import multiphase as mp
    from .models.scalar import segment, segment_fixed
    from .models.vector import segment_vector, segment_vector_fixed
    from .ops.diffusion import perona_malik
    from .utils import image_io, trace as trace_util

    if not args.color and (len(args.lambda1) > 1 or len(args.lambda2) > 1):
        print("error: per-channel --lambda1/--lambda2 need --color",
              file=sys.stderr)
        return 2
    if args.gif_every <= 0 or args.checkpoint_every <= 0:
        print("error: --gif-every and --checkpoint-every must be positive",
              file=sys.stderr)
        return 2

    def warn_dropped(path_name, *opts):
        dropped = [name for name, val in opts if val]
        if dropped and not args.quiet:
            print(f"warning: {', '.join(dropped)} not supported on the "
                  f"{path_name} path; ignored", file=sys.stderr)

    def diverged_exit(iters, *signals):
        """Exit 1 (skipping output artifacts) if any signal went
        non-finite - a diverged run must not look like a success to
        scripted callers."""
        if any(not np.all(np.isfinite(np.asarray(s))) for s in signals):
            print(f"DIVERGED after {iters} iters (non-finite level set - "
                  f"check the input for NaN/Inf and the parameter scales); "
                  f"no outputs written", file=sys.stderr)
            return True
        return False

    dtype = jnp.float64 if args.f64 else jnp.float32
    try:
        img = image_io.load_image(args.input, color=args.color)
    except FileNotFoundError:
        print(f"error: cannot open input image {args.input!r}",
              file=sys.stderr)
        return 2
    u0 = jnp.asarray(img, dtype)
    if args.smooth:
        u0 = perona_malik(u0, steps=args.smooth, kappa=args.smooth_kappa)

    p = CVParams(mu=args.mu, nu=args.nu,
                 lambda1=args.lambda1[0], lambda2=args.lambda2[0],
                 dt=args.dt, eps=args.eps, tol=args.tol,
                 max_iter=args.max_iter, conv_norm=args.conv,
                 init=args.init, order=args.order,
                 reinit_every=args.reinit_every)

    fixed = args.iters is not None
    log = (lambda *a: None) if args.quiet else (
        lambda *a: print(*a, file=sys.stderr))

    if args.pyramid and (fixed or (args.mesh is not None
                                   and args.multiphase)):
        # the coarse-to-fine warm start is a tolerance-mode surface;
        # fixed-iteration counts keep their exact-schedule semantics,
        # and the sharded multiphase driver has no pyramid composition
        warn_dropped("fixed-iteration/sharded-multiphase",
                     ("--pyramid", True))
        args.pyramid = 0

    if (args.morph or args.morph_gac) and args.multiphase:
        # the morphological schemes are two-phase; M coupled level sets
        # stay on the PDE multiphase path
        warn_dropped("multiphase", ("--morph", args.morph),
                     ("--morph-gac", args.morph_gac))
        args.morph = args.morph_gac = False

    if args.multiphase:
        if args.mesh is not None:
            from .parallel.mesh import make_grid_mesh
            from .parallel.sharded import (
                segment_multiphase_sharded,
                segment_multiphase_sharded_fixed_trace)

            mesh = make_grid_mesh(*args.mesh)
            if not fixed:
                warn_dropped("sharded multiphase tolerance-mode",
                             ("--trace-energy", args.trace_energy),
                             ("--evolution-gif", args.evolution_gif),
                             ("--checkpoint-dir", args.checkpoint_dir))
                res = segment_multiphase_sharded(
                    u0, p, mesh, m_sets=args.multiphase, fixed=False,
                    halo=args.halo, comm_k=args.comm_k)
                labels, iters, sig = res.labels, int(res.iters), res.cs
            elif args.trace_energy:
                if args.checkpoint_dir or args.comm_k > 1:
                    warn_dropped("sharded multiphase traced",
                                 ("--checkpoint-dir", args.checkpoint_dir),
                                 ("--comm-k", args.comm_k > 1))
                tr = segment_multiphase_sharded_fixed_trace(
                    u0, p, mesh, iters=args.iters, m_sets=args.multiphase,
                    halo=args.halo)
                trace_util.write_energy_csv(args.trace_energy, tr.energy,
                                            tr.delta)
                labels, iters, sig = tr.labels, args.iters, tr.energy[-1]
            elif args.checkpoint_dir:
                from .utils.checkpoint_sharded import (
                    segment_multiphase_sharded_with_checkpoints)

                if args.comm_k > 1:
                    warn_dropped("sharded multiphase checkpointed",
                                 ("--comm-k", True))
                res = segment_multiphase_sharded_with_checkpoints(
                    u0, p, mesh, iters=args.iters,
                    ckpt_dir=args.checkpoint_dir,
                    every=args.checkpoint_every, m_sets=args.multiphase,
                    halo=args.halo)
                labels, iters, sig = res.labels, args.iters, res.cs
                log(f"multiphase sharded checkpointed run -> "
                    f"{args.checkpoint_dir}")
            else:
                res = segment_multiphase_sharded(
                    u0, p, mesh, m_sets=args.multiphase,
                    max_iter=args.iters, fixed=True, halo=args.halo,
                    comm_k=args.comm_k)
                labels, iters, sig = res.labels, args.iters, res.cs
            if fixed and args.evolution_gif:
                # chunked re-run threading phis0; frames show phi_0's
                # contour (bit 0 of the labels, the overlay convention).
                # Frame boundaries snap to comm_k multiples so the
                # frozen-means cadence reproduces the saved trajectory.
                # The traced/checkpointed branches DROP comm_k for the
                # main run (warned above), so the re-run must too -
                # otherwise the gif shows a different trajectory class
                # than the saved labels/CSV.
                from .models.multiphase import init_multiphase

                gif_comm_k = (1 if (args.trace_energy
                                    or args.checkpoint_dir)
                              else args.comm_k)
                frames = []
                phis = init_multiphase(u0.shape[:2], args.multiphase,
                                       dtype=dtype)
                n = 0
                step_iters = args.gif_every
                if gif_comm_k > 1:
                    step_iters = -(-step_iters // gif_comm_k) \
                        * gif_comm_k
                while n < args.iters:
                    chunk = min(step_iters, args.iters - n)
                    r = segment_multiphase_sharded(
                        u0, p, mesh, m_sets=args.multiphase, phis0=phis,
                        max_iter=chunk, fixed=True, halo=args.halo,
                        comm_k=gif_comm_k)
                    phis = r.phis
                    n += chunk
                    frames.append(np.asarray(phis[0]))
                image_io.save_evolution_gif(args.evolution_gif, img,
                                            frames)
            if diverged_exit(iters, sig):
                return 1
            log(f"multiphase sharded {args.mesh[0]}x{args.mesh[1]}: "
                f"{2 ** args.multiphase} phases, {iters} iters")
            if args.output:
                image_io.save_labels(args.output, np.asarray(labels))
            if args.overlay:
                image_io.save_overlay(args.overlay, img,
                                      np.asarray(labels) % 2 == 1)
            return 0
        if fixed and args.checkpoint_dir:
            from .utils.checkpoint import segment_multiphase_with_checkpoints

            warn_dropped("multiphase checkpointed",
                         ("--trace-energy", args.trace_energy),
                         ("--evolution-gif", args.evolution_gif))
            res = segment_multiphase_with_checkpoints(
                u0, p, iters=args.iters, ckpt_dir=args.checkpoint_dir,
                every=args.checkpoint_every, m_sets=args.multiphase)
            labels, iters = res.labels, args.iters
            if diverged_exit(iters, res.cs):
                return 1
            log(f"multiphase checkpointed run -> {args.checkpoint_dir}")
        elif fixed:
            tr = mp.segment_multiphase_fixed(u0, p, iters=args.iters,
                                             m_sets=args.multiphase)
            labels, iters = tr.labels, args.iters
            if args.trace_energy:
                trace_util.write_energy_csv(args.trace_energy, tr.energy,
                                            tr.delta)
            if diverged_exit(iters, tr.energy[-1]):
                return 1
        elif args.pyramid:
            from .models.pyramid import segment_pyramid_multiphase

            lv = None if args.pyramid < 0 else args.pyramid
            res = segment_pyramid_multiphase(u0, p,
                                             m_sets=args.multiphase,
                                             levels=lv)
            labels, iters = res.labels, int(res.iters)
            if diverged_exit(iters, res.cs, res.delta):
                return 1
            log(f"pyramid levels: {res.level_iters} iters coarse->fine")
        else:
            res = mp.segment_multiphase(u0, p, m_sets=args.multiphase)
            labels, iters = res.labels, int(res.iters)
            if diverged_exit(iters, res.cs, res.delta):
                return 1
        log(f"multiphase: {2 ** args.multiphase} phases, {iters} iters")
        if args.output:
            image_io.save_labels(args.output, labels)
        if args.overlay:
            image_io.save_overlay(args.overlay, img,
                                  np.asarray(labels) % 2 == 1)
        return 0

    lam1 = tuple(args.lambda1) if args.color else None
    lam2 = tuple(args.lambda2) if args.color else None

    if args.morph_gac:
        from .models.morph_gac import (segment_gac, segment_gac_fixed,
                                       segment_gac_sharded)
        from .ops.morph import inverse_gaussian_gradient

        if args.checkpoint_dir or args.trace_energy:
            warn_dropped("morphological-GAC",
                         ("--checkpoint-dir", args.checkpoint_dir),
                         ("--trace-energy", args.trace_energy))
        if args.pyramid and args.mesh is not None:
            warn_dropped("sharded morphological-GAC",
                         ("--pyramid", True))
            args.pyramid = 0
        s = args.morph_smoothing
        g = inverse_gaussian_gradient(u0, args.gac_alpha, args.gac_sigma)
        thr = (float(np.percentile(np.asarray(g), 40))
               if args.gac_threshold == "auto"
               else float(args.gac_threshold))
        kw = dict(smoothing=s, balloon=args.balloon, threshold=thr)
        if args.pyramid:
            from .models.pyramid import segment_pyramid_gac

            res = segment_pyramid_gac(
                u0, p, levels=args.pyramid, gac_alpha=args.gac_alpha,
                gac_sigma=args.gac_sigma, **kw)
            mask, iters, delta = res.mask, int(res.iters), res.delta
            log(f"pyramid levels (coarse->fine iters): {res.level_iters}")
        elif fixed:
            tr = segment_gac_fixed(g, p, iters=args.iters, **kw)
            mask, iters, delta = tr.mask, args.iters, tr.delta[-1]
            if args.evolution_gif:
                # chunked re-run threading the level set; start_iter
                # keeps the SIoIS/ISoSI alternation of the main run
                frames, ls, n = [], None, 0
                while n < args.iters:
                    chunk = min(args.gif_every, args.iters - n)
                    t = segment_gac_fixed(g, p, iters=chunk, ls0=ls,
                                          start_iter=n, **kw)
                    ls = t.ls
                    n += chunk
                    frames.append(np.asarray(ls) - 0.5)
                image_io.save_evolution_gif(args.evolution_gif, img,
                                            frames)
        elif args.mesh is not None:
            from .parallel.mesh import make_grid_mesh

            gmesh = make_grid_mesh(*args.mesh)
            if args.comm_k > 1:
                # communication-avoiding chunks: one deep halo exchange
                # per k iterations, trajectory-exact for GAC
                from .parallel.sharded_morph import \
                    segment_gac_sharded_chunked

                res = segment_gac_sharded_chunked(
                    g, p, mesh=gmesh, comm_k=args.comm_k, **kw)
            else:
                res = segment_gac_sharded(g, p, mesh=gmesh, **kw)
            mask, iters, delta = res.mask, int(res.iters), res.delta
        else:
            res = segment_gac(g, p, **kw)
            mask, iters, delta = res.mask, int(res.iters), res.delta
        if diverged_exit(iters, delta):
            return 1
        log(f"morphGAC: {iters} iters; balloon={args.balloon}, "
            f"threshold={thr:.4g}")
        if args.output:
            image_io.save_mask(args.output, np.asarray(mask))
        if args.overlay:
            image_io.save_overlay(args.overlay, img, np.asarray(mask))
        return 0

    if args.morph:
        from .models.morph import (segment_morph, segment_morph_fixed,
                                   segment_morph_sharded)

        if args.checkpoint_dir:
            warn_dropped("morphological",
                         ("--checkpoint-dir", args.checkpoint_dir))
        if args.pyramid and args.mesh is not None:
            warn_dropped("sharded morphological", ("--pyramid", True))
            args.pyramid = 0
        s = args.morph_smoothing
        if args.pyramid:
            from .models.pyramid import segment_pyramid_morph

            res = segment_pyramid_morph(u0, p, levels=args.pyramid,
                                        smoothing=s, lambda1=lam1,
                                        lambda2=lam2)
            log(f"pyramid levels (coarse->fine iters): {res.level_iters}")
            from .ops.morph import binary_means as _bm

            c1, c2 = _bm(u0, res.ls)
            mask, iters, delta = res.mask, int(res.iters), res.delta
            if diverged_exit(iters, c1, c2, delta):
                return 1
            log(f"morphACWE: {iters} iters; c1={np.asarray(c1)}, "
                f"c2={np.asarray(c2)}")
            if args.output:
                image_io.save_mask(args.output, np.asarray(mask))
            if args.overlay:
                image_io.save_overlay(args.overlay, img, np.asarray(mask))
            return 0
        mesh = None
        if args.mesh is not None:
            # GSPMD path: place the inputs on the grid mesh; the same
            # jitted drivers compile sharded (segment_morph_sharded's
            # docstring explains why morph needs no shard_map)
            from jax.sharding import NamedSharding, PartitionSpec as _P

            from .models.morph import _init_ls
            from .parallel.mesh import make_grid_mesh

            mesh = make_grid_mesh(*args.mesh)
            if fixed:
                spec = _P("x", "y") if u0.ndim == 2 else _P("x", "y", None)
                ls_seed = jax.device_put(
                    _init_ls(u0, p, None), NamedSharding(mesh, _P("x", "y")))
                u0 = jax.device_put(u0, NamedSharding(mesh, spec))
        if fixed:
            ls_seed = ls_seed if mesh is not None else None
            tr = segment_morph_fixed(u0, p, iters=args.iters, ls0=ls_seed,
                                     smoothing=s,
                                     lambda1=lam1, lambda2=lam2)
            mask, iters = tr.mask, args.iters
            c1, c2 = tr.c1[-1], tr.c2[-1]
            if args.trace_energy:
                trace_util.write_energy_csv(args.trace_energy, tr.energy,
                                            tr.delta, tr.c1, tr.c2)
            if args.evolution_gif:
                # chunked re-run threading the level set; start_iter keeps
                # the SIoIS/ISoSI alternation identical to the main run
                frames, ls, n = [], ls_seed, 0
                while n < args.iters:
                    chunk = min(args.gif_every, args.iters - n)
                    t = segment_morph_fixed(u0, p, iters=chunk, ls0=ls,
                                            smoothing=s, lambda1=lam1,
                                            lambda2=lam2, start_iter=n)
                    ls = t.ls
                    n += chunk
                    frames.append(np.asarray(ls) - 0.5)
                image_io.save_evolution_gif(args.evolution_gif, img,
                                            frames)
            delta = tr.delta[-1]
        elif mesh is not None:
            if args.comm_k > 1:
                # communication-avoiding chunks (frozen means per chunk,
                # the banded kernel's trajectory class)
                from .parallel.sharded_morph import \
                    segment_morph_sharded_chunked

                res = segment_morph_sharded_chunked(
                    u0, p, mesh=mesh, smoothing=s, comm_k=args.comm_k,
                    lambda1=lam1, lambda2=lam2)
            else:
                res = segment_morph_sharded(u0, p, mesh=mesh, smoothing=s,
                                            lambda1=lam1, lambda2=lam2)
            mask, iters = res.mask, int(res.iters)
            c1, c2, delta = res.c1, res.c2, res.delta
        else:
            res = segment_morph(u0, p, smoothing=s,
                                lambda1=lam1, lambda2=lam2)
            mask, iters = res.mask, int(res.iters)
            c1, c2, delta = res.c1, res.c2, res.delta
        if diverged_exit(iters, c1, c2, delta):
            return 1
        log(f"morphACWE: {iters} iters; c1={np.asarray(c1)}, "
            f"c2={np.asarray(c2)}")
        if args.output:
            image_io.save_mask(args.output, np.asarray(mask))
        if args.overlay:
            image_io.save_overlay(args.overlay, img, np.asarray(mask))
        return 0

    if args.mesh is not None:
        from .parallel.mesh import make_grid_mesh
        from .parallel.sharded import (segment_sharded,
                                       segment_sharded_fixed_trace)

        mesh = make_grid_mesh(*args.mesh)
        if not fixed:
            # the per-iteration trace/checkpoint/gif surfaces need a fixed
            # iteration count, exactly like the unsharded paths
            warn_dropped("sharded tolerance-mode",
                         ("--trace-energy", args.trace_energy),
                         ("--evolution-gif", args.evolution_gif),
                         ("--checkpoint-dir", args.checkpoint_dir))
            if args.pyramid:
                from .models.pyramid import segment_pyramid_sharded

                res = segment_pyramid_sharded(
                    u0, p, mesh,
                    levels=(None if args.pyramid < 0 else args.pyramid),
                    lambda1=lam1, lambda2=lam2, halo=args.halo,
                    comm_k=args.comm_k)
                log(f"pyramid per-level iters (coarse -> fine): "
                    f"{res.level_iters}")
            else:
                res = segment_sharded(u0, p, mesh, fixed=False,
                                      lambda1=lam1, lambda2=lam2,
                                      halo=args.halo,
                                      comm_k=args.comm_k)
            mask, iters, c1, c2 = res.mask, int(res.iters), res.c1, res.c2
        elif args.trace_energy:
            # the trace program has no comm_k variant (there is no
            # frozen-means parity reference to trace against)
            if args.checkpoint_dir or args.comm_k > 1:
                warn_dropped("sharded traced",
                             ("--checkpoint-dir", args.checkpoint_dir),
                             ("--comm-k", args.comm_k > 1))
            tr = segment_sharded_fixed_trace(
                u0, p, mesh, iters=args.iters, lambda1=lam1, lambda2=lam2,
                halo=args.halo)
            trace_util.write_energy_csv(args.trace_energy, tr.energy,
                                        tr.delta, tr.c1, tr.c2)
            mask, iters = tr.mask, args.iters
            c1, c2 = tr.c1[-1], tr.c2[-1]
        elif args.checkpoint_dir:
            if args.color:
                warn_dropped("sharded color",
                             ("--checkpoint-dir", args.checkpoint_dir))
                res = segment_sharded(u0, p, mesh, max_iter=args.iters,
                                      fixed=True, lambda1=lam1,
                                      lambda2=lam2, halo=args.halo)
            else:
                from .utils.checkpoint_sharded import (
                    segment_sharded_with_checkpoints)

                res = segment_sharded_with_checkpoints(
                    u0, p, mesh, iters=args.iters,
                    ckpt_dir=args.checkpoint_dir,
                    every=args.checkpoint_every, halo=args.halo,
                    comm_k=args.comm_k)
                log(f"sharded checkpointed run -> {args.checkpoint_dir}")
            mask, iters, c1, c2 = res.mask, args.iters, res.c1, res.c2
        else:
            res = segment_sharded(u0, p, mesh, max_iter=args.iters,
                                  fixed=True, lambda1=lam1, lambda2=lam2,
                                  halo=args.halo,
                                  comm_k=args.comm_k)
            mask, iters, c1, c2 = res.mask, args.iters, res.c1, res.c2
        if fixed and args.evolution_gif:
            # chunked re-run threading phi0, as in the unsharded gif path
            from .parallel.sharded import _make_phi0
            frames = []
            phi = _make_phi0(u0.shape[:2], p.init, dtype, mesh)
            n = 0
            # snap frame boundaries to comm_k multiples: the chunked
            # re-run restarts the frozen-means cadence at each phi0
            # handoff, so only aligned boundaries reproduce the
            # trajectory that produced the saved mask (the final
            # remainder chunk matches the unchunked run's remainder).
            # The traced branch DROPS comm_k for the main run (warned
            # above) - mirror that here or the gif trajectory diverges
            # from the saved mask/CSV.
            gif_comm_k = 1 if args.trace_energy else args.comm_k
            step_iters = args.gif_every
            if gif_comm_k > 1:
                step_iters = -(-step_iters // gif_comm_k) * gif_comm_k
            while n < args.iters:
                chunk = min(step_iters, args.iters - n)
                r = segment_sharded(u0, p, mesh, phi0=phi, max_iter=chunk,
                                    fixed=True, lambda1=lam1, lambda2=lam2,
                                    halo=args.halo,
                                    comm_k=gif_comm_k)
                phi = r.phi
                n += chunk
                frames.append(np.asarray(phi))
            image_io.save_evolution_gif(args.evolution_gif, img, frames)
        if diverged_exit(iters, c1, c2):
            return 1
        log(f"sharded over {args.mesh[0]}x{args.mesh[1]} mesh; "
            f"{iters} iters; c1={np.asarray(c1)}, c2={np.asarray(c2)}")
        if args.output:
            image_io.save_mask(args.output, np.asarray(mask))
        if args.overlay:
            image_io.save_overlay(args.overlay, img, np.asarray(mask))
        return 0

    if fixed and args.checkpoint_dir:
        from .utils import checkpoint as ckpt

        warn_dropped("checkpointed", ("--trace-energy", args.trace_energy),
                     ("--evolution-gif", args.evolution_gif))

        phi = ckpt.segment_with_checkpoints(
            u0, p, iters=args.iters, ckpt_dir=args.checkpoint_dir,
            every=args.checkpoint_every, lambda1=lam1, lambda2=lam2)
        mask = np.asarray(phi) >= 0
        log(f"checkpointed run: {args.iters} iters -> "
            f"{args.checkpoint_dir}")
        if args.output:
            image_io.save_mask(args.output, mask)
        if args.overlay:
            image_io.save_overlay(args.overlay, img, mask)
        return 0

    if fixed:
        if args.color:
            tr = segment_vector_fixed(u0, p, iters=args.iters,
                                      lambda1=lam1, lambda2=lam2)
        else:
            tr = segment_fixed(u0, p, iters=args.iters)
        mask, iters, c1, c2 = tr.mask, args.iters, tr.c1[-1], tr.c2[-1]
        if args.trace_energy:
            trace_util.write_energy_csv(args.trace_energy, tr.energy,
                                        tr.delta, tr.c1, tr.c2)
        if args.evolution_gif:
            # re-run in chunks to collect frames (trace mode keeps only
            # the final phi on device)
            frames = []
            from .utils.init_phi import init_phi
            phi = init_phi(u0.shape[:2], p.init, dtype)
            n = 0
            while n < args.iters:
                chunk = min(args.gif_every, args.iters - n)
                t = (segment_vector_fixed(u0, p, iters=chunk,
                                          phi0=phi, lambda1=lam1,
                                          lambda2=lam2, start_iter=n)
                     if args.color else
                     segment_fixed(u0, p, iters=chunk, phi0=phi,
                                   start_iter=n))
                phi = t.phi
                n += chunk
                frames.append(np.asarray(phi))
            image_io.save_evolution_gif(args.evolution_gif, img, frames)
    else:
        if args.pyramid:
            from .models.pyramid import segment_pyramid

            res = segment_pyramid(
                u0, p, levels=(None if args.pyramid < 0 else args.pyramid),
                lambda1=lam1, lambda2=lam2)
            log(f"pyramid per-level iters (coarse -> fine): "
                f"{res.level_iters}")
        elif args.color:
            res = segment_vector(u0, p, lambda1=lam1, lambda2=lam2)
        else:
            res = segment(u0, p)
        mask, iters, c1, c2 = res.mask, int(res.iters), res.c1, res.c2

    if diverged_exit(iters, c1, c2):
        return 1
    log(f"converged in {iters} iters; c1={np.asarray(c1)}, "
        f"c2={np.asarray(c2)}")
    if args.output:
        image_io.save_mask(args.output, mask)
    if args.overlay:
        image_io.save_overlay(args.overlay, img, np.asarray(mask))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
