"""Stored golden traces (goldens/): guard against accidental numerics
drift across build rounds. The goldens are C-baseline f64 raster-GS runs
(the reference stand-in)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from chan_vese import CVParams, segment_fixed
from chan_vese.utils.init_phi import init_phi
from chan_vese.utils.trace import read_energy_csv
from fixtures import two_disks

GOLD = Path(__file__).resolve().parents[1] / "goldens"


def _fixture():
    img, _ = two_disks(64, 64, noise=8.0)
    return jnp.asarray(img, jnp.float64)


def test_stored_golden_matches_fresh_c_run():
    """The stored CSV must be exactly reproducible by the current C lib."""
    from native import baseline

    img, _ = two_disks(64, 64, noise=8.0)
    p = CVParams()
    phi0 = np.asarray(init_phi((64, 64), "checkerboard", jnp.float64),
                      np.float64)
    phi, e, d = baseline.segment_fixed(img, p, 60, phi0)
    gold = read_energy_csv(GOLD / "config1_64_checkerboard_f64.csv")
    np.testing.assert_allclose(e, gold["energy"], rtol=1e-10)
    # rtol 1e-10: absorbs last-ulp codegen variation across compiler
    # flags/refactors while still catching any real convention change
    np.testing.assert_allclose(
        phi, np.load(GOLD / "config1_64_checkerboard_phi.npy"), rtol=1e-10,
        atol=1e-10)


def test_jax_wavefront_matches_stored_golden():
    """Live JAX parity mode vs the stored reference-stand-in trace."""
    u = _fixture()
    for kind in ("checkerboard", "circle"):
        p = CVParams(order="wavefront", init=kind)
        tr = segment_fixed(u, p, iters=60)
        gold = read_energy_csv(GOLD / f"config1_64_{kind}_f64.csv")
        rel = np.abs(np.asarray(tr.energy) - gold["energy"]) \
            / np.abs(gold["energy"])
        assert float(rel.max()) < 1e-5, (kind, rel.max())


def test_redblack_converged_energy_near_golden():
    """The fast path lands at the same energy basin as the golden run."""
    u = _fixture()
    p = CVParams(init="circle")
    tr = segment_fixed(u, p, iters=60)
    gold = read_energy_csv(GOLD / "config1_64_circle_f64.csv")
    # ~4% gap: the energy's length term tracks the phi-drift magnitude,
    # whose rate is ordering-dependent (see test_scalar.py); masks agree
    assert abs(float(tr.energy[-1]) - gold["energy"][-1]) \
        / gold["energy"][-1] < 0.08