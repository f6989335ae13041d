"""Test configuration: the suite runs on an 8-device virtual CPU mesh.

JAX is pinned to the CPU before any array work, so the tests never reach
an accelerator even where one is present. Tests that need a real NVIDIA
GPU carry ``@pytest.mark.gpu``; the ``_gpu_only`` fixture skips them here
(decided inside the fixture, never at import time). On a card they run
with ``PCS_TEST_GPU=1 python -m pytest tests/ -m gpu``.
"""
import os

if not os.environ.get("PCS_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX's backend is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with PCS_TEST_GPU=1 on a card)")


# Tests measured at >= ~5 s on the virtual CPU mesh (a full-suite
# --durations run; dominated by per-test jit compiles, not assertions).
# They carry @pytest.mark.slow via the hook below so iteration runs can
# use the fast tier:   pytest tests/ -m "not slow"     (~5 min quiet)
# The FULL suite (~15 min quiet host) remains the bar before a commit
# that touches the compute path. Keyed by (file, originalname) so
# parametrized cases inherit the mark; tests can also carry the
# decorator directly.
_SLOW = {
    ("test_change.py", "test_segment_cli_changed_vs"),
    ("test_cluster.py", "test_after_plane_removal_workflow"),
    ("test_cluster.py", "test_long_chain_converges"),
    ("test_cluster.py", "test_segment_cli_end_to_end"),
    ("test_deproject.py", "test_deproject_batched_cameras"),
    ("test_deproject.py", "test_deproject_mixed_models_matches_oracle"),
    ("test_deproject.py", "test_map_color_matches_oracle"),
    ("test_filters.py", "test_frustum_cull_roundtrip_and_box"),
    ("test_fuzz_backends.py", "test_voxel_backends_agree_fuzz"),
    ("test_gicp.py", "test_register_cli_gicp_flag"),
    ("test_multihost.py", "test_package_import_does_not_initialize_backend"),
    ("test_multihost.py", "test_two_process_dcn_allgather"),
    ("test_ndt.py", "test_empty_inputs_fail_safe"),
    ("test_ndt.py", "test_identity_when_already_aligned"),
    ("test_ndt.py", "test_map_reuse_localizes_multiple_frames"),
    ("test_ndt.py", "test_recovers_small_offset"),
    ("test_normals_output.py", "test_flat_scene_normals_face_the_sensor"),
    ("test_p2plane.py",
     "test_point_to_plane_beats_point_to_point_on_smooth_scene"),
    ("test_p2plane.py", "test_stitcher_point_to_plane_drift_correction"),
    ("test_parallel.py", "test_sharded_colored_stream_matches_single_device"),
    ("test_parallel.py", "test_sharded_matches_single_device"),
    ("test_parallel.py",
     "test_sharded_mixed_distortion_matches_single_device"),
    ("test_parallel.py", "test_sharded_program_contains_collectives"),
    ("test_parallel.py", "test_shardmap_stitch_matches_single_device"),
    ("test_parallel.py",
     "test_shardmap_stitch_pallas_interpret_matches_single_device"),
    ("test_parallel.py",
     "test_shardmap_stitch_point_to_plane_matches_single_device"),
    ("test_pose_graph.py", "test_graph_cli_ply_mode"),
    ("test_pose_graph.py", "test_register_rig_end_to_end"),
    ("test_register_global.py", "test_fpfh_starts_alone_recover_pose"),
    ("test_register_global.py", "test_identity_start_keeps_aligned_pairs"),
    ("test_register_global.py",
     "test_recovers_large_rotation_without_picks"),
    ("test_register_global.py", "test_register_cli_global_end_to_end"),
    ("test_runtime.py", "test_overlap_pipeline_matches_serial"),
    ("test_sac.py", "test_finds_dominant_plane"),
    ("test_stitcher.py", "test_icp_drift_correction_improves_alignment"),
    ("test_stitcher.py", "test_pipeline_wrapper_carries_extrinsics"),
    ("test_stitcher.py", "test_ring_closure_bounds_chain_end_drift"),
    ("test_stitcher.py", "test_ring_closure_noop_when_consistent"),
    ("test_stitcher.py", "test_stitch_step_mapped_color"),
    ("test_tools.py", "test_pick_cli_to_register_cli_end_to_end"),
    ("test_tools.py", "test_register_cli_end_to_end"),
    ("test_tools.py", "test_stitch_cli_drop_plane"),
    ("test_tools.py", "test_stitch_cli_map_checkpoint_resume"),
    ("test_tools.py", "test_stitch_cli_native_color_with_calibration"),
    ("test_tools.py", "test_stitch_cli_temporal_map"),
    ("test_tools.py", "test_stitch_cli_tsdf_track_recovers_drift"),
    ("test_tools.py", "test_stitch_cli_with_intr_dir"),
    ("test_tsdf.py", "test_rig_track_beats_ring_icp_on_global_drift"),
    ("test_tsdf.py", "test_rig_track_lifts_correction_to_rig"),
    ("test_tsdf.py", "test_track_recovers_perturbed_pose"),
    ("test_vfh.py", "test_per_cluster_workflow_and_degenerate"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = getattr(item, "originalname", item.name)
        if (item.fspath.basename, name) in _SLOW:
            item.add_marker(pytest.mark.slow)
