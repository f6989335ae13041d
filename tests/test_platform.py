"""Process-level plumbing: the one kernel-selection point, the compile-cache
location, the flax-free pytree dataclasses, and the GPU-only entry points
refusing to fall back to the CPU."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pointcloud_stitching_tpu import Intrinsics, PointCloud
from pointcloud_stitching_tpu.utils import platform
from pointcloud_stitching_tpu.utils.types import (pytree_dataclass,
                                                  static_field)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- kernel selection ---------------------------------------------------------

@pytest.mark.parametrize("impl,interpret,want", [
    ("auto", False, "xla"),      # no GPU here: auto is the XLA form
    ("xla", False, "xla"),
    ("pallas", True, "pallas"),  # interpret mode: the CPU tests' route
])
def test_kernel_impl_resolves_on_cpu(impl, interpret, want):
    assert platform.kernel_impl(impl, interpret) == want


def test_kernel_impl_pallas_without_gpu_raises():
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        platform.kernel_impl("pallas")


def test_kernel_impl_refuses_interpret_mode_on_a_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    for impl in ("auto", "pallas"):
        with pytest.raises(ValueError, match="runs compiled"):
            platform.kernel_impl(impl, interpret=True)
    assert platform.kernel_impl("auto") == "pallas"
    assert platform.kernel_impl("xla", interpret=True) == "xla"


def test_kernel_impl_rejects_unknown():
    with pytest.raises(ValueError, match="unknown kernel impl"):
        platform.kernel_impl("mosaic")


def test_nearest_neighbors_pallas_without_gpu_raises(rng):
    from pointcloud_stitching_tpu.ops import nearest_neighbors
    q = jnp.asarray(rng.normal(size=(8, 3)).astype(np.float32))
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        nearest_neighbors(q, q, impl="pallas")


def test_integrate_mxu_is_mxu_xla_and_mxu_pallas_is_gone():
    from pointcloud_stitching_tpu.models import tsdf as M
    intr = Intrinsics.create(fx=50.0, fy=50.0, ppx=32.0, ppy=24.0,
                             width=64, height=48)
    d = jnp.full((48, 64), 1.0, jnp.float32)
    eye = jnp.eye(4, dtype=jnp.float32)
    a = M.integrate(M.TSDFVolume.create((16, 16, 16), 0.1), d, intr, eye,
                    depth_scale=1.0, method="mxu")
    b = M.integrate(M.TSDFVolume.create((16, 16, 16), 0.1), d, intr, eye,
                    depth_scale=1.0, method="mxu_xla")
    assert np.array_equal(np.asarray(a.tsdf), np.asarray(b.tsdf))
    with pytest.raises(ValueError, match="method"):
        M.integrate(M.TSDFVolume.create((16, 16, 16), 0.1), d, intr, eye,
                    method="mxu_pallas")


# -- compile cache ------------------------------------------------------------

def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert platform.compilation_cache_dir() == os.path.join(REPO,
                                                            ".jax_cache")


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.compilation_cache_dir() == str(tmp_path)


@pytest.mark.parametrize("with_env", [False, True])
def test_compiled_entries_land_in_cache_dir(tmp_path, with_env):
    """A fresh process with the helper writes its compiled program where
    the helper says: the env directory when set, else <checkout>/.jax_cache
    (here a throwaway copy of the package stands in for the checkout)."""
    import shutil
    checkout = tmp_path / "checkout"
    shutil.copytree(os.path.join(REPO, "pointcloud_stitching_tpu"),
                    checkout / "pointcloud_stitching_tpu",
                    ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    want = tmp_path / "env_cache" if with_env else checkout / ".jax_cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(checkout))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if with_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(want)
    code = (
        "import jax, jax.numpy as jnp\n"
        "from pointcloud_stitching_tpu.utils.platform import "
        "setup_compilation_cache\n"
        "print(setup_compilation_cache())\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((64, 64)))"
        ".block_until_ready()\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(want)
    assert want.is_dir() and any(want.iterdir())


# -- pytree dataclasses -------------------------------------------------------

@pytree_dataclass
class _Pair:
    a: jax.Array
    b: jax.Array = None
    n: int = static_field(3)


def test_pytree_dataclass_leaves_and_static_fields():
    p = _Pair(a=jnp.ones(2), b=jnp.zeros(3), n=7)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2                      # n is metadata, not a leaf
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert q.n == 7 and np.array_equal(np.asarray(q.b), np.zeros(3))
    # a static field is part of the treedef: different n, different tree
    assert treedef != jax.tree_util.tree_structure(dataclasses.replace(p,
                                                                       n=8))


def test_pytree_dataclass_jit_round_trip_and_replace():
    intr = Intrinsics.create(fx=100.0, fy=101.0, ppx=50.0, ppy=40.0,
                             width=100, height=80)

    @jax.jit
    def scale(i: Intrinsics) -> Intrinsics:
        assert i.width == 100                    # static: a python int
        return i.replace(fx=i.fx * 2.0)

    out = scale(intr)
    assert isinstance(out, Intrinsics)
    assert float(out.fx) == 200.0 and float(out.fy) == 101.0
    assert (out.width, out.height, out.model) == (100, 80, intr.model)
    with pytest.raises(dataclasses.FrozenInstanceError):
        out.fx = 1.0


def test_pointcloud_none_field_round_trips_through_jit():
    pc = PointCloud.from_points(np.zeros((5, 3), np.float32), capacity=8)
    out = jax.jit(lambda c: c.replace(xyz=c.xyz + 1.0))(pc)
    assert out.rgb is None and out.xyz.shape == (8, 3)
    assert int(out.count()) == 5


def test_package_imports_without_flax():
    code = ("import sys; sys.modules['flax'] = None\n"
            "import pointcloud_stitching_tpu.models\n"
            "import pointcloud_stitching_tpu.parallel\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# -- GPU-only entry points ----------------------------------------------------

@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_the_cpu(script):
    out = subprocess.run([sys.executable, os.path.join(REPO, script)],
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
