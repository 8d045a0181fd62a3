"""Drop-in convenience entry points.

``chan_vese(image, ...)`` mirrors the argument surface users know from the
reference CLI and the scikit-image function of the same name, returning
the binary mask (and optionally the full result). ``morphological_chan_vese(image, num_iter, ...)``
mirrors the sibling scikit-image function (the MorphACWE scheme,
models/morph.py), with ``checkerboard_level_set`` / ``disk_level_set``
named inits implemented to the published definitions.

Note the intensity convention: this framework's canonical operating point
is [0, 255] (see CVParams); pass ``normalize='255'`` (default) to rescale
[0, 1] float inputs up, or ``normalize=None`` to use the image as-is with
your own mu scaling.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def chan_vese(image,
              mu: float = 0.01 * 255.0 ** 2,
              nu: float = 0.0,
              lambda1=1.0,
              lambda2=1.0,
              tol: float = 1e-5,
              max_num_iter: int = 500,
              dt: float = 0.5,
              eps: float = 1.0,
              init_level_set="checkerboard",
              normalize: Optional[str] = "255",
              extended_output: bool = False):
    """Segment ``image`` (2D grayscale or 3D HxWxC) with Chan-Vese.

    Returns the boolean mask, or (mask, phi, result) with
    extended_output=True. Accepts numpy or jax arrays; floats in [0, 1]
    are rescaled to [0, 255] when normalize='255' and max(image) <= 1.

    ``init_level_set``: a named shape ('checkerboard' | 'circle'/'disk' |
    'small disk' | 'rect') or a custom (H, W) array used directly as phi0
    (skimage-compatible).
    """
    import jax.numpy as jnp

    from .models.scalar import segment
    from .params import CVParams

    img = np.asarray(image, np.float32)
    if normalize == "255" and img.size and float(img.max()) <= 1.0:
        img = img * 255.0

    vector = img.ndim == 3
    if not vector and (len(np.atleast_1d(lambda1)) > 1
                       or len(np.atleast_1d(lambda2)) > 1):
        raise ValueError("per-channel lambda weights need an (H, W, C) "
                         "image")
    l1 = tuple(np.atleast_1d(lambda1).astype(float)) if vector else None
    l2 = tuple(np.atleast_1d(lambda2).astype(float)) if vector else None
    if vector and len(l1) == 1:
        l1 = l1 * img.shape[-1]
    if vector and len(l2) == 1:
        l2 = l2 * img.shape[-1]

    # skimage-compat: init_level_set may be a custom (H, W) array instead
    # of a named shape; it is forwarded as phi0 (CVParams.init stays a
    # static string for jit hashing).
    phi0 = None
    init_kind = init_level_set
    if not isinstance(init_level_set, str):
        phi0 = jnp.asarray(np.asarray(init_level_set, img.dtype))
        if phi0.shape != img.shape[:2]:
            raise ValueError(
                f"init_level_set array shape {phi0.shape} does not match "
                f"image spatial shape {img.shape[:2]}")
        init_kind = "checkerboard"  # unused when phi0 is given

    p = CVParams(mu=mu, nu=nu,
                 lambda1=float(np.atleast_1d(lambda1)[0]),
                 lambda2=float(np.atleast_1d(lambda2)[0]),
                 dt=dt, eps=eps, tol=tol, max_iter=max_num_iter,
                 init=init_kind)
    res = segment(jnp.asarray(img), p, phi0, lambda1=l1, lambda2=l2)
    mask = np.asarray(res.mask)
    if extended_output:
        return mask, np.asarray(res.phi), res
    return mask

def checkerboard_level_set(image_shape, square_size: int = 5):
    """Binary checkerboard of square_size x square_size tiles (int8),
    the published MorphACWE default init: XOR of per-axis tile parities."""
    i, j = np.ogrid[:image_shape[0], :image_shape[1]]
    return np.int8(((i // square_size) + (j // square_size)) % 2)


def disk_level_set(image_shape, center=None, radius=None):
    """Binary disk (int8); defaults: centered, radius = 3/8 min(shape)."""
    if center is None:
        center = tuple(s // 2 for s in image_shape[:2])
    if radius is None:
        radius = min(image_shape[:2]) * 3.0 / 8.0
    i, j = np.ogrid[:image_shape[0], :image_shape[1]]
    r2 = (i - center[0]) ** 2 + (j - center[1]) ** 2
    return np.int8(r2 < radius * radius)


def morphological_chan_vese(image, num_iter: int,
                            init_level_set="checkerboard",
                            smoothing: int = 1,
                            lambda1=1.0, lambda2=1.0,
                            iter_callback=None):
    """MorphACWE with the scikit-image argument surface (models/morph.py).

    Runs EXACTLY ``num_iter`` iterations (no convergence test - matching
    the mirrored signature; use models.morph.segment_morph for the
    tolerance-mode driver) and returns the int8 binary level set.
    Intensity normalization is unnecessary here: the discrete force only
    contributes its SIGN, which is scale-invariant. Accepts (H, W) or,
    as an extension, (H, W, C) images with per-channel lambda sequences.
    Edge convention: replica/Neumann (module docstring of ops/morph.py)
    rather than ndimage's border_value=0 frame erosion.

    ``iter_callback(level_set)`` (optional) is invoked on the init and
    after every iteration with the current int8 level set - this forces
    one device round trip per iteration; omit it for the single-program
    fast path.
    """
    import jax.numpy as jnp

    from .models.morph import segment_morph_fixed
    from .params import CVParams

    img = np.asarray(image, np.float32)
    vector = img.ndim == 3
    l1 = tuple(np.atleast_1d(lambda1).astype(float)) if vector else float(
        np.atleast_1d(lambda1)[0])
    l2 = tuple(np.atleast_1d(lambda2).astype(float)) if vector else float(
        np.atleast_1d(lambda2)[0])
    if vector and len(l1) == 1:
        l1 = l1 * img.shape[-1]
    if vector and len(l2) == 1:
        l2 = l2 * img.shape[-1]

    if isinstance(init_level_set, str):
        if init_level_set == "checkerboard":
            ls = checkerboard_level_set(img.shape)
        elif init_level_set in ("circle", "disk"):
            ls = disk_level_set(img.shape)
        else:
            raise ValueError(f"unknown init_level_set {init_level_set!r}")
    else:
        ls = np.asarray(init_level_set)
        if ls.shape != img.shape[:2]:
            raise ValueError(
                f"init_level_set shape {ls.shape} does not match image "
                f"spatial shape {img.shape[:2]}")
    ls = jnp.asarray(np.asarray(ls, np.float32))

    # floats (gray) and tuples (per-channel) are both hashable, so they
    # pass straight through the drivers' static lambda arguments
    kw = dict(p=CVParams(), smoothing=int(smoothing),
              lambda1=l1, lambda2=l2)
    u0 = jnp.asarray(img)

    if iter_callback is None:
        res = segment_morph_fixed(u0, iters=int(num_iter), ls0=ls, **kw)
        return np.asarray(res.ls, np.int8)

    iter_callback(np.asarray(ls, np.int8))
    for n in range(int(num_iter)):
        res = segment_morph_fixed(u0, iters=1, ls0=ls, start_iter=n, **kw)
        ls = res.ls
        iter_callback(np.asarray(ls, np.int8))
    return np.asarray(ls, np.int8)


def inverse_gaussian_gradient(image, alpha: float = 100.0,
                              sigma: float = 5.0):
    """Edge-stopping map 1/sqrt(1 + alpha*|grad(G_sigma*image)|) as a
    float32 numpy array (the MorphGAC preprocessor; mirrors the
    scikit-image function of the same name). Computed on-device
    (ops/morph.py): Gaussian blur = scipy-identical discretized kernel
    with replica edges; gradient = central differences of the blurred
    plane (scikit-image uses derivative-of-Gaussian filters - same
    scale, interior values agree to the filters' commutation error).
    Accepts (H, W) or (H, W, C) (per-channel gradients' RSS)."""
    import jax.numpy as jnp

    from .ops.morph import inverse_gaussian_gradient as _igg

    img = jnp.asarray(np.asarray(image, np.float32))
    return np.asarray(_igg(img, float(alpha), float(sigma)))


def morphological_geodesic_active_contour(gimage, num_iter: int,
                                          init_level_set="disk",
                                          smoothing: int = 1,
                                          threshold="auto",
                                          balloon: int = 0,
                                          iter_callback=None):
    """MorphGAC with the scikit-image argument surface
    (models/morph_gac.py). ``gimage`` is the PREPROCESSED edge map
    (inverse_gaussian_gradient), not the raw image. Runs EXACTLY
    ``num_iter`` iterations and returns the int8 binary level set;
    threshold='auto' = the 40th percentile of gimage (the published
    default). Edge convention: replica/Neumann throughout (module
    docstring of ops/morph.py) rather than ndimage's border_value=0.

    ``iter_callback(level_set)`` (optional) is invoked on the init and
    after every iteration (one device round trip each; omit for the
    single-program fast path)."""
    import jax.numpy as jnp

    from .models.morph_gac import segment_gac_fixed, segment_gac_iterations
    from .params import CVParams

    g = np.asarray(gimage, np.float32)
    if g.ndim != 2:
        raise ValueError("gimage must be a 2D edge map "
                         "(inverse_gaussian_gradient output)")
    thr = float(np.percentile(g, 40)) if threshold == "auto" \
        else float(threshold)

    if isinstance(init_level_set, str):
        if init_level_set in ("circle", "disk"):
            ls = disk_level_set(g.shape)
        elif init_level_set == "checkerboard":
            ls = checkerboard_level_set(g.shape)
        else:
            raise ValueError(f"unknown init_level_set {init_level_set!r}")
    else:
        ls = np.asarray(init_level_set)
        if ls.shape != g.shape:
            raise ValueError(
                f"init_level_set shape {ls.shape} does not match gimage "
                f"shape {g.shape}")
    ls = jnp.asarray(np.asarray(ls, np.float32))
    gj = jnp.asarray(g)

    kw = dict(p=CVParams(), smoothing=int(smoothing),
              balloon=int(balloon), threshold=thr)

    if iter_callback is None:
        res = segment_gac_iterations(gj, iters=int(num_iter), ls0=ls, **kw)
        return np.asarray(res.ls, np.int8)

    iter_callback(np.asarray(ls, np.int8))
    for n in range(int(num_iter)):
        res = segment_gac_fixed(gj, iters=1, ls0=ls, start_iter=n, **kw)
        ls = res.ls
        iter_callback(np.asarray(ls, np.int8))
    return np.asarray(ls, np.int8)
