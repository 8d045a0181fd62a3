"""CPU-side checks of the GPU smoke script (chip_smoke.py), the persistent
compile-cache helper, the ``gpu`` test marker and the CLI's option
surface. The smoke script's GPU phases run only on a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run_smoke(cwd, script):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=600)


def _has_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_smoke_fails_without_gpu():
    proc = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)
    assert "needs an NVIDIA GPU" in proc.stderr


def test_smoke_fails_alone_in_a_directory(tmp_path):
    """Copied without the rest of the repository it cannot pass."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)


@pytest.mark.parametrize("a,b,want", [
    ([[1, 1], [0, 0]], [[1, 1], [0, 0]], 1.0),
    ([[1, 1], [0, 0]], [[1, 0], [0, 0]], 0.5),
    ([[1, 0], [0, 0]], [[0, 0], [0, 1]], 0.0),
    ([[0, 0], [0, 0]], [[0, 0], [0, 0]], 1.0),
])
def test_iou(a, b, want):
    assert chip_smoke.iou(np.array(a), np.array(b)) == pytest.approx(want)


@pytest.mark.parametrize("got,want,err", [
    ([1.0, 2.0], [1.0, 2.0], 0.0),
    ([1.1, 2.0], [1.0, 2.0], 0.1),
    ([1.0, -2.2], [1.0, -2.0], 0.1),
])
def test_max_rel(got, want, err):
    assert chip_smoke.max_rel(got, want) == pytest.approx(err)


def test_mask_mismatch_fraction():
    a = np.zeros((10, 10), bool)
    b = a.copy()
    b[0, :3] = True
    assert chip_smoke.mask_mismatch(a, b) == pytest.approx(0.03)


@pytest.mark.parametrize("energy,rise", [
    ([10.0, 9.0, 8.0], -0.1),
    ([10.0, 10.0], 0.0),
    ([10.0, 10.5, 10.0], 0.05),
    ([5.0], 0.0),
])
def test_max_energy_rise(energy, rise):
    assert chip_smoke.max_energy_rise(energy) == pytest.approx(rise)


def test_check_raises_on_failure(capsys):
    chip_smoke.check("passes", True, "detail")
    with pytest.raises(chip_smoke.SmokeFailure, match="fails: why"):
        chip_smoke.check("fails", False, "why")
    out = capsys.readouterr().out
    assert "[ok] passes" in out and "[FAIL] fails" in out


def test_two_disks_ground_truth_and_noise():
    img, gt = chip_smoke.two_disks(216, 384)
    assert img.dtype == np.float32 and img.shape == gt.shape == (216, 384)
    assert abs(float(img[gt].mean()) - 217.0) < 1.0
    assert abs(float(img[~gt].mean()) - 38.0) < 1.0
    # both disks reach inside the default circle init
    i, j = np.nonzero(gt)
    r = np.hypot(i - 107.5, j - 191.5)
    assert (r < 54.0).any() and (r > 54.0).any()


def test_two_disks_segmented_by_the_circle_init_at_small_size():
    """The smoke's 4K check, at a size the CPU can run: the tolerance
    solve from the circle init reaches IoU 1 on the two disks."""
    from chan_vese import CVParams, segment

    img, gt = chip_smoke.two_disks(135, 240)
    res = segment(jax.numpy.asarray(img), CVParams(init="circle"))
    assert chip_smoke.iou(res.mask, gt) >= chip_smoke.MIN_IOU


# --------------------------------------------------------------------------
# persistent compile cache
# --------------------------------------------------------------------------

def test_compile_cache_honours_env_var():
    from chan_vese.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    got = enable_compile_cache({"JAX_COMPILATION_CACHE_DIR": "/some/dir"})
    assert got == "/some/dir"
    assert jax.config.jax_compilation_cache_dir == before  # untouched


def test_compile_cache_default_is_fixed_path_in_checkout():
    from chan_vese.compile_cache import DEFAULT_DIR, enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        got = enable_compile_cache({})
        assert got == str(REPO / ".jax_cache") == str(DEFAULT_DIR)
        assert jax.config.jax_compilation_cache_dir == got
        assert enable_compile_cache({}) == got  # stable across calls
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_dir_is_gitignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


# --------------------------------------------------------------------------
# the gpu marker
# --------------------------------------------------------------------------

def test_gpu_fixture_skips_without_a_gpu():
    from conftest import gpu_devices, require_gpu

    assert gpu_devices() == []
    with pytest.raises(pytest.skip.Exception, match="NVIDIA GPU"):
        require_gpu()


def test_gpu_marker_is_registered():
    text = (REPO / "pyproject.toml").read_text()
    assert 'markers = ["gpu:' in text


# --------------------------------------------------------------------------
# CLI options that chose a removed kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--no-fused"], ["--halo", "rdma"]])
def test_cli_rejects_removed_flags(flags, tmp_path, capsys):
    from chan_vese.cli import main

    src = tmp_path / "in.npy"
    np.save(src, np.zeros((8, 8), np.float32))
    with pytest.raises(SystemExit) as e:
        main([str(src)] + flags)
    assert e.value.code == 2
    assert "error" in capsys.readouterr().err
