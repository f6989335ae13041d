"""Core data types for the point-cloud stitching framework.

Design notes
------------
Everything on-device is **fixed shape**: point clouds are padded buffers with a
validity mask. This replaces the reference's dynamically sized
``pcl::PointCloud<pcl::PointXYZRGB>`` (reference: src/pcs-multicamera-client.cpp,
which grows clouds with ``operator+=``) with an XLA-friendly struct-of-arrays
layout so every kernel traces once and never recompiles as point counts change.

Camera intrinsics mirror librealsense's ``rs2_intrinsics`` (reference layer L0,
``rs2::pointcloud::calculate`` — see SURVEY.md §2.2): fx, fy, ppx, ppy plus a
5-coefficient Brown–Conrady distortion model.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree.

    Fields declared with ``static_field`` are treedef metadata (hashed into
    the jit cache key; a change retraces); every other field is a leaf.
    ``.replace(**changes)`` returns a copy with fields swapped.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = dataclasses.replace
    return cls


def static_field(default):
    """A ``pytree_dataclass`` field that is metadata, not a leaf."""
    return dataclasses.field(default=default, metadata={"static": True})


class DistortionModel(enum.IntEnum):
    """Distortion models, matching librealsense's rs2_distortion enum semantics."""

    NONE = 0
    BROWN_CONRADY = 1          # forward model: distort during projection
    INVERSE_BROWN_CONRADY = 2  # forward model applied during deprojection
    # static sentinel for a camera batch mixing the models above; the actual
    # per-camera ids ride in the traced Intrinsics.model_ids array (a real
    # D400 fleet does mix models, so a rig must be expressible — deprojection
    # computes every correction branchlessly and selects per camera)
    MIXED = -1


@pytree_dataclass
class Intrinsics:
    """Pinhole + Brown–Conrady intrinsics for one depth camera.

    ``width``/``height``/``model`` are static (they change the traced program);
    the focal/principal/distortion parameters are traced arrays so one compiled
    kernel serves any calibration.
    """

    fx: jax.Array
    fy: jax.Array
    ppx: jax.Array
    ppy: jax.Array
    coeffs: jax.Array  # [5] Brown–Conrady: k1, k2, p1, p2, k3
    # per-camera distortion ids (traced int32, batch-shaped) — only present
    # when model == MIXED; None otherwise so the static fast paths stay
    # single-branch
    model_ids: Optional[jax.Array] = None
    width: int = static_field(848)
    height: int = static_field(480)
    model: int = static_field(int(DistortionModel.NONE))

    @classmethod
    def create(cls, fx, fy, ppx, ppy, coeffs=None, width=848, height=480,
               model=DistortionModel.NONE) -> "Intrinsics":
        if coeffs is None:
            coeffs = jnp.zeros((5,), jnp.float32)
        return cls(
            fx=jnp.asarray(fx, jnp.float32),
            fy=jnp.asarray(fy, jnp.float32),
            ppx=jnp.asarray(ppx, jnp.float32),
            ppy=jnp.asarray(ppy, jnp.float32),
            coeffs=jnp.asarray(coeffs, jnp.float32),
            width=int(width),
            height=int(height),
            model=int(model),
        )

    @classmethod
    def d435_default(cls, width=848, height=480) -> "Intrinsics":
        """Nominal D435 848x480 depth intrinsics (typical factory values)."""
        return cls.create(fx=425.0, fy=425.0, ppx=width / 2.0, ppy=height / 2.0,
                          width=width, height=height)

    def stack(self, others: list["Intrinsics"]) -> "Intrinsics":
        """Stack per-camera intrinsics into a batched Intrinsics (leading axis).

        Cameras may mix distortion models (the batched model becomes MIXED
        with traced per-camera model_ids; deprojection selects per camera).
        Resolutions must match — the depth stack is one fixed-shape
        [ncam, H, W] array; pad mixed-resolution rigs to a common H, W
        before building Intrinsics.
        """
        all_i = [self, *others]
        if any(i.width != self.width or i.height != self.height
               for i in all_i):
            raise ValueError(
                "stacked cameras must share width/height (pad mixed-"
                "resolution rigs to a common shape first)")
        models = [i.model for i in all_i]
        if any(m == int(DistortionModel.MIXED) for m in models):
            raise ValueError("cannot re-stack an already-MIXED Intrinsics")
        mixed = len(set(models)) > 1
        return Intrinsics(
            fx=jnp.stack([i.fx for i in all_i]),
            fy=jnp.stack([i.fy for i in all_i]),
            ppx=jnp.stack([i.ppx for i in all_i]),
            ppy=jnp.stack([i.ppy for i in all_i]),
            coeffs=jnp.stack([i.coeffs for i in all_i]),
            model_ids=(jnp.asarray(models, jnp.int32) if mixed else None),
            width=self.width, height=self.height,
            model=(int(DistortionModel.MIXED) if mixed else self.model),
        )


@pytree_dataclass
class PointCloud:
    """Fixed-capacity padded point cloud.

    xyz:  [..., N, 3] float32 (meters)
    rgb:  [..., N, 3] float32 in [0, 255] or None
    mask: [..., N]    bool — True where the slot holds a real point
    """

    xyz: jax.Array
    mask: jax.Array
    rgb: Optional[jax.Array] = None

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)

    @classmethod
    def from_points(cls, xyz, rgb=None, capacity: Optional[int] = None) -> "PointCloud":
        """Build a cloud from a dense [N,3] array, padding to ``capacity``."""
        xyz = jnp.asarray(xyz, jnp.float32)
        n = xyz.shape[-2]
        cap = capacity or n
        pad = cap - n
        if pad < 0:
            raise ValueError(f"capacity {cap} < point count {n}")
        mask = jnp.concatenate(
            [jnp.ones((n,), bool), jnp.zeros((pad,), bool)], axis=0)
        xyz = jnp.concatenate([xyz, jnp.zeros((pad, 3), jnp.float32)], axis=-2)
        if rgb is not None:
            rgb = jnp.asarray(rgb, jnp.float32)
            rgb = jnp.concatenate([rgb, jnp.zeros((pad, 3), jnp.float32)], axis=-2)
        return cls(xyz=xyz, mask=mask, rgb=rgb)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
