"""Declarative pipeline configuration.

Replaces the reference's scattered getopt flags + hard-coded IP lists
(reference: main() of src/pcs-camera-server.cpp and
src/pcs-multicamera-client.cpp — SURVEY.md §5 'Config / flag system') with one
dataclass. Fields here are *static*: they fix buffer shapes and the traced
program. Quantities that may change per frame without recompiling (leaf
sizes, extrinsics, intrinsics parameters) are traced arguments instead.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    """Static shape/program configuration for the stitching pipeline."""

    num_cameras: int = 4
    height: int = 480
    width: int = 848
    depth_scale: float = 0.001
    z_min: float = 0.1
    z_max: float = 10.0
    decimation: int = 1          # grid-stride depth decimation (server-side in ref)
    with_color: bool = False
    # attach per-point surface normals to the fused output (the
    # pcl::PointNormal capability — downstream meshing/shading/registration
    # needs them). Normals come free from the organized depth grid (one
    # cross product per pixel — no KD-tree, no eigensolve), rotate to world
    # frame with the refined extrinsics, and ride the voxel sort as a
    # quantized 3x8-bit packed operand (the colored-cloud machinery), so
    # the per-voxel normal is the renormalized member average. Decode with
    # ops.normals.decode_normals. Mutually exclusive with with_color (both
    # use the cloud's rgb channel); depth payloads only (the legacy points
    # payload has no grid to derive normals from).
    with_normals: bool = False
    # non-aligned color stream resolution (DEPTH16_COLOR_NATIVE wire kind):
    # None = color is depth-aligned [height, width]. When set, the pipeline
    # texture-maps color through separate color intrinsics + depth->color
    # extrinsics (StitchingPipeline color_intr/color_ext).
    color_height: int | None = None
    color_width: int | None = None

    # optional per-camera voxel pre-downsample. Off by default: on one
    # device, fusing raw clouds into one global voxel pass matches the
    # reference dataflow (transform -> concat -> one VoxelGrid). Turn on for
    # multi-device meshes to bound the per-camera cloud that crosses the
    # interconnect.
    cam_voxel_enabled: bool = False
    cam_voxel_leaf: float = 0.01
    cam_capacity: int = 131072

    # fused output cloud
    out_voxel_leaf: float = 0.01
    out_capacity: int = 262144
    # optional world-frame crop of the fused cloud (pcl::CropBox role):
    # (x, y, z) lower/upper corners in meters, None = no crop. Applied
    # before the output voxel pass so out-of-scene points (windows, far
    # walls) don't consume output capacity. Mask-only — zero cost.
    crop_lo: tuple[float, float, float] | None = None
    crop_hi: tuple[float, float, float] | None = None
    # adaptive output resolution: when the fixed-capacity output grid
    # saturates (points_out == out_capacity: the sorted tail of voxels is
    # dropped, a spatially biased amputation), StitchingPipeline feeds the
    # leaf back through a per-frame controller (models.autofit_out_leaf):
    # grow until the scene fits, shrink back toward out_voxel_leaf (the
    # floor = the finest/target resolution) when it would fit with
    # headroom. The leaf is a *traced* operand, so adaptation never
    # recompiles — the fixed-shape answer to PCL's unbounded realloc.
    out_leaf_autofit: bool = False
    out_leaf_max: float = 0.08   # controller ceiling (meters)

    # per-frame ICP drift correction (config 4/5); BASELINE: >=5 iters/frame
    icp_enabled: bool = True
    icp_stride: int = 6        # grid-stride subsample feeding the ICP clouds
    # ICP-cloud density knobs. NN cost scales with icp_capacity^2, so 2048
    # is the default. IMPORTANT: pick leaf so the
    # expected per-camera voxel count FITS capacity — overflow drops the
    # sorted tail, i.e. a spatially biased amputation of the ICP cloud
    # (measured on the rendered partial-overlap rig: cap 2048 @ 5 cm leaf
    # overflows and leaves 38.8% of injected drift; @ 7 cm it fits and
    # leaves 4.1%, matching cap 4096 @ 5 cm at 3.3%).
    icp_voxel_leaf: float = 0.07
    icp_capacity: int = 2048
    icp_iterations: int = 5
    icp_max_corr_dist: float = 0.1
    # trimmed ICP: additionally drop this fraction of the worst accepted
    # matches each iteration. Measured on the rendered partial-overlap ring
    # (8 cams, common height-field, drift injected): at 77% adjacent
    # overlap trim=0.1 leaves 3.3% of injected drift vs 14.7% untrimmed;
    # at 92% overlap the two are equal within noise (1-2%). Robustness for
    # realistic rigs, so 0.1 is the default; set 0.0 for the
    # pure-PCL-default behavior.
    icp_trim_fraction: float = 0.1
    # measure the closing pair (camera 0 vs camera n-1) too and distribute
    # the loop residual along the chain: chain-end drift stays bounded
    # instead of compounding with ncam. No effect below 3 cameras.
    icp_ring_closure: bool = True
    # closure sanity gate (meters): skip distributing a closing residual
    # whose translation exceeds this — per-frame drift corrections are
    # centimeter-scale, so a large residual means the closing pair has no
    # true overlap (open ring) or ICP slid to a false alignment, and
    # distributing it corrupts every camera. loop_error still reports it.
    icp_closure_gate: float = 0.25
    # rotation arm of the same gate (radians): a closing residual rotating
    # more than this is just as implausible as a large translation — a
    # rotation-dominated false closure (ICP slid around a rotationally
    # ambiguous surface) would otherwise pass a translation-only gate and
    # corrupt every camera. ~0.26 rad = 15 degrees; per-frame drift is
    # sub-degree.
    icp_closure_gate_rot: float = 0.26
    # 'point_to_plane' (default: grid normals, converges in ~half the
    # iterations, no smooth-surface sliding) or 'point_to_point' (the
    # reference's PCL default). Measured on the 8-cam drift-recovery rig:
    # p2plane@3 leaves 1.2% of injected drift; p2point@5 left 165% (it
    # slides on smooth surfaces), so p2plane is the default.
    icp_variant: str = "point_to_plane"
    icp_query_tile: int = 1024
    icp_ref_tile: int = 4096

    # NN kernel choice for the ICP drift stage, resolved by
    # utils.platform.kernel_impl: 'auto' (the Pallas kernel on a GPU, XLA
    # elsewhere), 'xla', 'pallas'. The GSPMD sharded path
    # (parallel/mesh.py) forces 'xla' — a Pallas custom call has no GSPMD
    # partitioning rule, so under pjit it would replicate. The shard_map
    # path (parallel/shard_stitch.py) honours it: each device runs the
    # kernel locally.
    kernel_impl: str = "auto"
    # run the Pallas kernel in interpret mode (CPU tests of the
    # kernel_impl='pallas' path; refused on a GPU)
    kernel_interpret: bool = False


    def __post_init__(self):
        if self.num_cameras < 1:
            raise ValueError("num_cameras must be >= 1")
        if self.icp_variant not in ("point_to_point", "point_to_plane"):
            raise ValueError(f"unknown icp_variant {self.icp_variant!r}")
        if self.kernel_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown kernel_impl {self.kernel_impl!r}")
        if not (0.0 <= self.icp_trim_fraction < 1.0):
            raise ValueError("icp_trim_fraction must be in [0, 1)")
        for name in ("cam_capacity", "out_capacity", "icp_capacity"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be positive")
        if self.decimation < 1:
            raise ValueError("decimation must be >= 1")
        if self.decimation > 1 and (self.height % self.decimation
                                    or self.width % self.decimation):
            # decimate_depth's ::d slice yields ceil(H/d) rows but the
            # stitcher's organized-grid reshape uses H//d — a
            # non-divisible stride would crash at trace time with an
            # opaque reshape error; fail here with the actual contract
            raise ValueError(
                f"decimation {self.decimation} must divide height "
                f"{self.height} and width {self.width}")
        if self.out_leaf_autofit and self.out_leaf_max < self.out_voxel_leaf:
            raise ValueError("out_leaf_max must be >= out_voxel_leaf")
        if self.with_normals and self.with_color:
            raise ValueError("with_normals and with_color are mutually "
                             "exclusive (both ride the cloud's rgb channel)")
        if (self.color_height is None) != (self.color_width is None):
            raise ValueError("set both color_height and color_width or neither")
        if self.color_height is not None and not self.with_color:
            raise ValueError("color_height/width require with_color=True")
        if (self.crop_lo is None) != (self.crop_hi is None):
            raise ValueError("set both crop_lo and crop_hi or neither")
        if self.crop_lo is not None:
            # JSON round-trips tuples as lists; the config must stay
            # hashable (it keys the jit cache), so normalise here
            lo, hi = tuple(self.crop_lo), tuple(self.crop_hi)
            if len(lo) != 3 or len(hi) != 3:
                raise ValueError("crop_lo/crop_hi must have 3 components")
            if not all(a < b for a, b in zip(lo, hi)):
                raise ValueError("crop_lo must be < crop_hi per axis")
            object.__setattr__(self, "crop_lo", lo)
            object.__setattr__(self, "crop_hi", hi)

    @property
    def pixels_per_camera(self) -> int:
        return (self.height // self.decimation) * (self.width // self.decimation)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "StitchConfig":
        return cls(**json.loads(s))

    @classmethod
    def load(cls, path: str) -> "StitchConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
