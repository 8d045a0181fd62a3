"""Fault injection: elastic recovery of checkpointed sharded runs
(SURVEY.md §5 failure-detection row — "a multi-slice run restarts from
the last φ checkpoint"; VERDICT r3 marked the row partial for lack of an
injected-fault demonstration).

The injected fault is an uncontrolled SIGKILL mid-run (not a tidy exit
at a chunk boundary): the victim process dies right as its third
checkpoint save begins, leaving an UNCOMMITTED orbax tmp directory on
disk. Recovery must (a) ignore the uncommitted wreckage, (b) resume from
the last committed checkpoint, and (c) reproduce the uninterrupted run
bit-exactly (same chunk boundaries -> same trajectory).
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.params import CVParams
from chan_vese.parallel import mesh as meshmod
from chan_vese.utils import checkpoint_sharded as cks
from fixtures import two_disks

_CHILD = r"""
import os, signal, sys
from pathlib import Path
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
from chan_vese.params import CVParams
from chan_vese.parallel import mesh as meshmod
from chan_vese.utils import checkpoint_sharded as cks
from fixtures import two_disks

mesh = meshmod.make_grid_mesh(2, 4)
img, _ = two_disks(32, 64, noise=4.0)
u0 = jnp.asarray(img, jnp.float64)
p = CVParams()

real_save = cks.save_sharded
state = {{"n": 0}}

def save_and_die_on_third(path_dir, step, phi, c1=None, c2=None):
    state["n"] += 1
    if state["n"] == 3:
        # die MID-save: leave an uncommitted orbax tmp dir, then SIGKILL
        junk = Path(path_dir) / f"ckpt_{{step:08d}}.orbax-checkpoint-tmp-1"
        junk.mkdir(parents=True, exist_ok=True)
        (junk / "manifest.ocdbt").write_bytes(b"partial write")
        os.kill(os.getpid(), signal.SIGKILL)
    return real_save(path_dir, step, phi, c1, c2)

cks.save_sharded = save_and_die_on_third
cks.segment_sharded_with_checkpoints(u0, p, mesh, iters=80,
                                     ckpt_dir={ckdir!r}, every=20)
raise SystemExit("unreachable: the injected fault did not fire")
"""


@pytest.fixture(scope="module")
def grid_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (fake) devices")
    return meshmod.make_grid_mesh(2, 4)


def test_sigkill_mid_save_resumes_bit_exact(grid_mesh, tmp_path):
    repo = Path(__file__).resolve().parents[1]
    ckdir = tmp_path / "ck"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (str(repo) + os.pathsep + str(repo / "tests")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    code = _CHILD.format(repo=str(repo), tests=str(repo / "tests"),
                         ckdir=str(ckdir))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(repo), capture_output=True, text=True,
                          timeout=1800)
    # the victim must have died by the injected SIGKILL, not a tidy exit
    assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                proc.stderr[-2000:])

    # wreckage on disk: two committed checkpoints + one uncommitted tmp
    names = sorted(f.name for f in ckdir.iterdir())
    assert "ckpt_00000020" in names and "ckpt_00000040" in names
    assert any("orbax-checkpoint-tmp" in n for n in names), names
    latest = cks.latest_sharded(ckdir)
    assert latest is not None and latest.name == "ckpt_00000040"

    # recovery: resume to completion, compare to an uninterrupted run
    img, _ = two_disks(32, 64, noise=4.0)
    u0 = jnp.asarray(img, jnp.float64)
    p = CVParams()
    res = cks.segment_sharded_with_checkpoints(
        u0, p, grid_mesh, iters=80, ckpt_dir=ckdir, every=20)
    # it RESUMED (wrote 60 and 80 on top of 40) rather than replaying
    names = {f.name for f in ckdir.iterdir()}
    assert {"ckpt_00000060", "ckpt_00000080"} <= names, names
    ref = cks.segment_sharded_with_checkpoints(
        u0, p, grid_mesh, iters=80, ckpt_dir=tmp_path / "ref", every=20)
    np.testing.assert_array_equal(np.asarray(res.phi), np.asarray(ref.phi))
