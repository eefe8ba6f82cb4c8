"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

This file imports no jax, so it runs on a machine with a card and no jax:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

Without a CUDA device every test skips (decided inside the fixture).
Tolerances: B1, each sum within 2e-5 of its Cauchy-Schwarz scale
(``assoc_gn.sum_errors``; float32 sums of 65536 terms in two tree orders),
the match count exact.  B2 forms the same float32 sums in the same order
as its plain version: identical indices, squared distances bit-identical
(0 ulp).
"""
import numpy as np
import pytest
import torch

from pylidar_slam_tpu_torch.ops.kernels import assoc_gn as b1
from pylidar_slam_tpu_torch.ops.kernels import nn_argmin as b2
from pylidar_slam_tpu_torch.ops.kernels import seams

H, W = 64, 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _images(dev):
    rng = np.random.default_rng(0)
    base = np.cumsum(rng.normal(size=(H, W, 3)).astype(np.float32) * 0.1, axis=1)
    base += np.array([20.0, -5.0, 1.0], np.float32)
    timg = base + rng.normal(size=(H, W, 3)).astype(np.float32) * 0.05
    model = base + rng.normal(size=(H, W, 3)).astype(np.float32) * 0.05
    normals = rng.normal(size=(H, W, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    valid = rng.random((H, W)) < 0.9
    model[~valid] = 0.0
    normals[~valid] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (timg, model, normals, valid)]


@pytest.mark.gpu
@pytest.mark.parametrize("plane_gate", [0.0, 0.05])
@pytest.mark.parametrize("scheme", sorted(b1.SCHEME_IDS))
def test_assoc_gn_kernel_matches_plain(cuda, scheme, plane_gate):
    args = (*_images(cuda), 1, 2, 0.6, scheme, 0.4, plane_gate)
    before = b1.assoc_gn.launches
    ours = b1.assoc_gn(*args)
    again = b1.assoc_gn(*args)
    assert b1.assoc_gn.launches == before + 2
    ref = b1.assoc_gn_plain(*args)
    ours, again, ref = (x.cpu().numpy().astype(np.float64) for x in (ours, again, ref))
    assert np.array_equal(ours, again)  # no float atomics: bit-repeatable
    assert ours[28] == ref[28] > 0
    assert b1.sum_errors(ours, ref)[1] <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("region", ["wrap columns", "border rows", "strip edges", "all"])
@pytest.mark.parametrize("h,w,wr,wc", [(64, 1024, 1, 2), (16, 1000, 1, 2),
                                       (8, 1022, 2, 3), (8, 300, 0, 0),
                                       (16, 1000, 3, 20), (128, 1024, 1, 2),
                                       (8, 1024, 2, 6)])
def test_assoc_gn_seams_match_plain(cuda, region, h, w, wr, wc):
    """Matches across the azimuth wrap, beyond the border rows and on the
    kernel's strip edges; W off the strip width and off a multiple of 16
    (the per-float staging), no window, a wide window on the 16-byte
    staging, a halo over 48 KB of shared memory, and more blocks than one
    pass of the final sum."""
    images = [torch.from_numpy(a).to(cuda) for a in seams.assoc_seam_images(h, w, region)]
    for scheme, plane in (("geman_mcclure", 0.0), ("neighborhood", 0.05)):
        args = (*images, wr, wc, 0.6, scheme, 0.4, plane)
        ours = b1.assoc_gn(*args).cpu().numpy().astype(np.float64)
        ref = b1.assoc_gn_plain(*args).cpu().numpy().astype(np.float64)
        assert ours[28] == ref[28] > 0
        assert b1.sum_errors(ours, ref)[1] <= 2e-5


@pytest.mark.gpu
def test_assoc_gn_repeats_bit_for_bit(cuda):
    """200 calls in a row give the same sums: the last-block counter is
    back at 0 after every call."""
    args = (*_images(cuda), 1, 2, 0.6, "geman_mcclure", 0.4, 0.0)
    first = b1.assoc_gn(*args)
    outs = torch.stack([b1.assoc_gn(*args) for _ in range(200)])
    assert torch.equal(outs, first.expand_as(outs))



@pytest.mark.gpu
def test_assoc_gn_on_concurrent_streams(cuda):
    """Two threads, each on a CUDA stream of its own (the CLI's parallel
    jobs), launch B1 at once: each stream draws tickets from a counter of
    its own, so every pass gives the one-stream sums bit for bit."""
    import threading
    args = (*_images(cuda), 1, 2, 0.6, "geman_mcclure", 0.4, 0.0)
    ref = b1.assoc_gn(*args).cpu()
    out, before = {}, b1.assoc_gn.launches

    def job(k):
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            out[k] = [b1.assoc_gn(*args) for _ in range(100)]
            torch.cuda.current_stream(cuda).synchronize()
    threads = [threading.Thread(target=job, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert b1.assoc_gn.launches == before + 200
    for sums in out.values():
        assert all(torch.equal(s.cpu(), ref) for s in sums)

@pytest.mark.gpu
def test_assoc_gn_rejects_bad_inputs(cuda):
    timg, model, normals, valid = _images(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        b1.assoc_gn(timg.transpose(0, 1).contiguous().transpose(0, 1), model,
                    normals, valid, 1, 2, 0.6, "geman_mcclure", 0.4)
    with pytest.raises(ValueError, match="float32"):
        b1.assoc_gn(timg.double(), model, normals, valid, 1, 2, 0.6,
                    "geman_mcclure", 0.4)


@pytest.mark.gpu
def test_failed_build_raises_on_cuda_tensors(cuda, monkeypatch, tmp_path):
    """With no compiler, a CUDA call raises instead of running the plain
    version."""
    from pylidar_slam_tpu_torch.ops.kernels import cuda_build
    from pylidar_slam_tpu_torch.utils import build
    monkeypatch.setattr(cuda_build, "nvcc_path",
                        lambda: str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    b1._library.cache_clear()
    before = b1.assoc_gn.launches
    try:
        with pytest.raises(build.BuildError):
            b1.assoc_gn(*_images(cuda), 1, 2, 0.6, "geman_mcclure", 0.4)
    finally:
        b1._library.cache_clear()
    assert b1.assoc_gn.launches == before


def _assert_nn_matches_plain(queries, model, valid):
    before = b2.nn_argmin.launches
    idx, sq = b2.nn_argmin(queries, model, valid)
    idx2, sq2 = b2.nn_argmin(queries, model, valid)
    assert b2.nn_argmin.launches == before + 2
    ridx, rsq = b2.nn_argmin_plain(queries, model, valid)
    assert idx.dtype == torch.int32 and sq.dtype == torch.float32
    assert torch.equal(idx, idx2) and torch.equal(sq, sq2)  # bit-repeatable
    assert torch.equal(idx, ridx)
    idx, sq, rsq = idx.cpu().numpy(), sq.cpu().numpy(), rsq.cpu().numpy()
    finite = np.isfinite(rsq)
    assert np.array_equal(np.isfinite(sq), finite)
    ulps = np.abs(sq[finite].view(np.int32).astype(np.int64)
                  - rsq[finite].view(np.int32).astype(np.int64))
    assert ulps.size == 0 or ulps.max() == 0
    return idx, sq


def _nn_case(dev, m, v, seed=0, frac_valid=0.9):
    rng = np.random.default_rng(seed)
    model = (rng.normal(size=(v, 3)) * 20).astype(np.float32)
    queries = (model[rng.integers(0, v, size=m)]
               + rng.normal(size=(m, 3)).astype(np.float32) * 0.3)
    valid = rng.random(v) < frac_valid
    return [torch.from_numpy(a).to(dev) for a in (queries, model, valid)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,v", [(16384, 122880), (1001, 12345), (1, 1), (300, 7)])
def test_nn_argmin_kernel_matches_plain(cuda, m, v):
    """The surfel champion's shapes, and sizes that are no multiple of the
    kernel's tiles."""
    idx, _ = _assert_nn_matches_plain(*_nn_case(cuda, m, v))
    assert idx.min() >= 0 and idx.max() < v


@pytest.mark.gpu
def test_nn_argmin_duplicates_and_empty_map(cuda):
    queries, model, valid = _nn_case(cuda, 1000, 3000)
    dup = torch.cat([model, model, model])  # row i == i + 3000 == i + 6000
    dup_valid = torch.cat([valid, torch.ones_like(valid), torch.ones_like(valid)])
    idx, _ = _assert_nn_matches_plain(model[::3] + 0.01, dup, dup_valid)
    rows = np.arange(0, 3000, 3)
    assert np.array_equal(idx, np.where(valid.cpu().numpy()[rows], rows, rows + 3000))
    idx, sq = _assert_nn_matches_plain(queries, dup, torch.zeros_like(dup_valid))
    assert np.all(idx == 0) and np.all(np.isinf(sq))


@pytest.mark.gpu
@pytest.mark.parametrize("m,v", [(16384, 122880), (16384 + 77, 122880 - 100),
                                 (1000, 12345), (513, 257), (1, 300)])
def test_nn_argmin_seams_match_plain(cuda, m, v):
    """Exact ties across sub-tile, tile and split boundaries and at the
    last row (the lower index wins), an all-invalid sub-tile and tile
    between finite ones; the champion's shapes first, then M off the
    queries per block and V off the tile."""
    case = seams.nn_seam_case(m, v)
    idx, _ = _assert_nn_matches_plain(*(torch.from_numpy(a).to(cuda) for a in
                                        (case.queries, case.model, case.valid)))
    assert np.array_equal(idx[case.tie_rows], case.tie_index)


@pytest.mark.gpu
def test_nn_argmin_active_flag(cuda):
    """False skips the pass without a host sync (index 0, +inf); True
    computes it; both launch the kernel."""
    args = _nn_case(cuda, 4096, 20000)
    before = b2.nn_argmin.launches
    idx, sq = b2.nn_argmin(*args, active=torch.zeros((), dtype=torch.bool, device=cuda))
    assert bool((idx == 0).all()) and bool(torch.isinf(sq).all())
    on = b2.nn_argmin(*args, active=torch.ones((), dtype=torch.bool, device=cuda))
    full = b2.nn_argmin(*args)
    assert torch.equal(on[0], full[0]) and torch.equal(on[1], full[1])
    assert b2.nn_argmin.launches == before + 3


@pytest.mark.gpu
def test_nn_argmin_rejects_bad_inputs(cuda):
    queries, model, valid = _nn_case(cuda, 64, 256)
    with pytest.raises(ValueError, match="contiguous"):
        b2.nn_argmin(queries.t().contiguous().t(), model, valid)
    with pytest.raises(ValueError, match="float32"):
        b2.nn_argmin(queries.double(), model, valid)
    with pytest.raises(ValueError, match="bool"):
        b2.nn_argmin(queries, model, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="active"):
        b2.nn_argmin(queries, model, valid, active=torch.ones(2, dtype=torch.bool,
                                                              device=cuda))


@pytest.mark.gpu
def test_icp_refine_on_b2_matches_the_cpu(cuda):
    """The loop closure's refine on the card (B2, the device flag skipping
    frozen and gated-off candidates) against the same refine on the CPU
    (the plain version): launches counted per candidate and trip, poses
    within 1e-4."""
    from pylidar_slam_tpu_torch.ops import icp3d
    rng = np.random.default_rng(3)
    cloud = rng.uniform(-20, 20, (4096, 3)).astype(np.float32)
    cloud[:, 2] *= 0.1
    rot = np.array([[np.cos(0.05), -np.sin(0.05), 0], [np.sin(0.05), np.cos(0.05), 0],
                    [0, 0, 1]], np.float32)
    target = (cloud @ rot.T + np.array([0.3, -0.2, 0.0], np.float32))[None].repeat(3, 0)
    masks = np.ones((3, 4096), bool)
    masks[:, 4000:] = False
    active = torch.tensor([True, True, False])
    args = [torch.from_numpy(cloud), torch.from_numpy(target), torch.from_numpy(masks)]
    cpu = icp3d.icp_align(args[0], args[1], target_mask=args[2], active=active,
                          max_corr_dist=2.0)
    before = b2.nn_argmin.launches
    dev = icp3d.icp_align(*(a.to(cuda) for a in args[:2]), target_mask=args[2].to(cuda),
                          active=active.to(cuda), max_corr_dist=2.0)
    assert b2.nn_argmin.launches == before + 3 * 20
    assert torch.equal(dev.num_iters.cpu(), cpu.num_iters)
    assert int(dev.num_iters[2]) == 0
    np.testing.assert_allclose(dev.transform.cpu().numpy(), cpu.transform.numpy(), atol=1e-4)


# -- the batched aggregated odometry as CUDA-graph replays --------------------

GRAPH_H, GRAPH_W, GRAPH_B = 64, 1024, 4
GRAPH_N = 1 + 4 * GRAPH_B + 2  # frame 0, four batches, a remainder of 2
GRAPH_COUNTS = ("count.odometry.graph_captures", "count.odometry.graph_replays")


def _graph_frames(upload):
    """The acceptance world's frames at 64 x 1,024; the third batch as
    (H, W, 3) vertex maps, a new upload key.  For float32 uploads every
    third frame carries 30,000 zero rows (invalid points), which moves its
    host bucket from 65,536 to 98,304 rows."""
    from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                          SyntheticDatasetLoader)
    from pylidar_slam_tpu_torch.eval import acceptance
    from pylidar_slam_tpu_torch.ops import projection
    loader = SyntheticDatasetLoader(SyntheticConfig(**dict(
        acceptance.SEQ_KW, lidar_height=GRAPH_H, lidar_width=GRAPH_W, num_frames=GRAPH_N)))
    ds = loader.sequences()[0][0][0]
    proj = loader.projector()
    frames = []
    for i in range(GRAPH_N):
        pc = ds[i]["numpy_pc"]
        if 1 + 2 * GRAPH_B <= i < 1 + 3 * GRAPH_B:
            pts = torch.from_numpy(pc)
            pc = projection.build_vertex_map(pts, proj, mask=torch.ones(len(pts), dtype=torch.bool)).numpy()
        elif upload == "f32" and i % 3 == 0:
            pc = np.concatenate([pc, np.zeros((30000, 3), np.float32)])
        frames.append({"numpy_pc": pc})
    return loader.projector(), frames


def _graph_odometry(proj, upload, cuda, graphed=True):
    import dataclasses
    from pylidar_slam_tpu_torch.eval import acceptance
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel
    over = dict(batch_size=GRAPH_B, device=str(cuda), upload_format=upload)
    if upload == "f32":
        over["num_points_padded"] = 6 * 16384
    odom = ICPFrameToModel(dataclasses.replace(acceptance.champion_configs()["aggregated"],
                                               **over), projector=proj)
    if not graphed:  # the eager reference: every batch through the map's batch_step
        odom._step_graphed = lambda pts, msks: None
    return odom


def _run_graph_frames(odom, frames, names=GRAPH_COUNTS):
    from pylidar_slam_tpu_torch.utils import timer
    before, launches = timer.snapshot(), b1.assoc_gn.launches
    for f in frames:
        odom.process_next_frame(dict(f))
    params = odom.fetch_params_log()
    after = timer.snapshot()
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in names}
    return params, [t.clone() for t in odom._map_state], counts, b1.assoc_gn.launches - launches


@pytest.mark.gpu
@pytest.mark.parametrize("upload", ["rimg8", "f32"])
def test_graphed_odometry_equals_eager(cuda, upload):
    """Replays against eager steps over four batches and a remainder:
    poses and map state equal to the bit.  The float32 bucket change keeps
    the graph (frames are padded to capacity on the card); the vertex-map
    batch captures a second graph.  B1 counts 8 launches a stepped frame
    either way: a capture is not counted, each replay adds its 8."""
    proj, frames = _graph_frames(upload)
    eager = _run_graph_frames(_graph_odometry(proj, upload, cuda, False), frames)
    graphed = _run_graph_frames(_graph_odometry(proj, upload, cuda, True), frames)
    assert np.array_equal(graphed[0], eager[0])
    for a, b in zip(graphed[1], eager[1]):
        assert torch.equal(a, b)
    assert eager[2] == {k: 0 for k in GRAPH_COUNTS}
    # batch 1 eager; 2 captures (its first frame eager) and replays 3; 3
    # captures the vertex-map key and replays 3; 4 and the remainder replay
    assert graphed[2] == {"count.odometry.graph_captures": 2,
                          "count.odometry.graph_replays": 3 + 3 + GRAPH_B + 2}
    assert eager[3] == graphed[3] == 8 * (GRAPH_N - 1)


SURFEL_COUNTS = GRAPH_COUNTS + ("count.surfel.nn_calls", "count.surfel.nn_active_calls",
                                "count.surfel.nn_pairs", "count.surfel.knn_dropped")


@pytest.mark.gpu
@pytest.mark.parametrize("local_map", [{"nn_backend": "exact", "normals_mode": "knn"},
                                       {"nn_backend": "hash", "normals_mode": "image"}],
                         ids=["exact-knn", "hash-image"])
def test_graphed_surfel_odometry_equals_eager(cuda, local_map):
    """The surfel champion batched by 4 on float32 uploads, exact search on
    B2 with k-NN map normals or the hash grid with the scan's normals:
    replays against eager steps over four batches and a remainder, with a
    vertex-map batch as a second key.  Poses, the seven state tensors and
    the device counts equal to the bit; the host's ``surfel.nn_calls`` and
    B2's launches are 20 a frame stepped either way (the hash grid
    launches none), since each replay adds what the capture recorded."""
    import dataclasses
    from pylidar_slam_tpu_torch.eval import acceptance
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel
    proj, frames = _graph_frames("f32")
    cfg = acceptance.champion_configs()["surfel"]
    cfg = dataclasses.replace(cfg, local_map=dict(cfg.local_map, **local_map),
                              batch_size=GRAPH_B, device=str(cuda),
                              num_points_padded=6 * 16384)
    runs = []
    for graphed in (False, True):
        odom = ICPFrameToModel(cfg, projector=proj)
        assert odom._map.graph_safe
        if not graphed:
            odom._step_graphed = lambda pts, msks: None
        searches = b2.nn_argmin.launches
        run = _run_graph_frames(odom, frames, SURFEL_COUNTS)
        runs.append(run + (b2.nn_argmin.launches - searches,))
    eager, graphed = runs
    assert np.array_equal(graphed[0], eager[0])
    assert len(graphed[1]) == 7
    for a, b in zip(graphed[1], eager[1]):
        assert torch.equal(a, b)
    for name in SURFEL_COUNTS[2:]:
        assert graphed[2][name] == eager[2][name], name
    assert graphed[2]["count.odometry.graph_captures"] == 2
    assert graphed[2]["count.odometry.graph_replays"] == 3 + 3 + GRAPH_B + 2
    trips = 20 * (GRAPH_N - 1) if local_map["nn_backend"] == "exact" else 0
    assert graphed[2]["count.surfel.nn_calls"] == trips
    assert graphed[4] == eager[4] == trips
    assert graphed[3] == eager[3] == 0
    if trips:
        assert 0 < graphed[2]["count.surfel.nn_active_calls"] < trips


@pytest.mark.gpu
def test_replay_under_sync_debug_and_profiler(cuda):
    """A flush of replays makes no host sync, adds 8 B1 launches a frame,
    and the profiler sees every replayed B1 kernel by its name, the graph
    having been captured before the profiler started."""
    from torch.profiler import ProfilerActivity, profile
    proj, frames = _graph_frames("rimg8")
    odom = _graph_odometry(proj, "rimg8", cuda)
    _run_graph_frames(odom, frames[:1 + 2 * GRAPH_B])  # the capture
    from pylidar_slam_tpu_torch.utils import timer
    batch = frames[1:1 + GRAPH_B]
    torch.cuda.synchronize()
    before, launches = timer.snapshot(), b1.assoc_gn.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in batch:
            odom.process_next_frame(dict(f))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = timer.snapshot()
    assert {k: after.get(k, 0) - before.get(k, 0) for k in GRAPH_COUNTS} == \
        {"count.odometry.graph_captures": 0, "count.odometry.graph_replays": GRAPH_B}
    assert b1.assoc_gn.launches - launches == 8 * GRAPH_B
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(256):  # the profiler may drop a window's first records
            torch.cuda._sleep(1000)
        _run_graph_frames(odom, batch)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("assoc_gn" in n for n in names) == 8 * GRAPH_B


def _block_state(ptr):
    """The caching allocator's state of the block that holds address `ptr`."""
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for blk in seg["blocks"]:
            addr = blk.get("address", addr)
            if addr <= ptr < addr + blk["size"]:
                return blk["state"]
            addr += blk["size"]
    return None


def _fill_free_small_blocks(cuda):
    """Takes every free block of the allocator's small pools on PyTorch's
    32 pool streams (where a capture's stream comes from) with 512-byte
    tensors of 7s, and returns them."""
    free = {}
    for seg in torch.cuda.memory_snapshot():
        if seg.get("segment_type") == "small" and \
                tuple(seg.get("segment_pool_id", (0, 0))) == (0, 0):  # not a graph's pool
            n = sum(b["size"] for b in seg["blocks"] if b["state"] == "inactive") // 512
            free[seg["stream"]] = free.get(seg["stream"], 0) + n
    fillers = []
    for _ in range(32):
        stream = torch.cuda.Stream(cuda)
        with torch.cuda.stream(stream):
            fillers += [torch.full((1,), 7, dtype=torch.int32, device=cuda)
                        for _ in range(free.get(stream.cuda_stream, 0))]
    torch.cuda.synchronize()
    return fillers


@pytest.mark.gpu
def test_graph_keeps_b1_counter_alive(cuda, monkeypatch):
    """A graph's B1 ticket counter lives as long as the graph: once the
    capture has returned and its scope is collected, the counter's block is
    still allocated; with every free small block of the pool streams then
    taken by tensors of 7s, the later replays equal the eager path and
    write none of those tensors."""
    import contextlib
    import gc
    counters = []
    capture = b1.capture

    @contextlib.contextmanager
    def recorded(device):
        with capture(device) as scope:
            counters.append(scope.counter.data_ptr())
            yield scope
    monkeypatch.setattr(b1, "capture", recorded)
    proj, frames = _graph_frames("rimg8")
    eager = _run_graph_frames(_graph_odometry(proj, "rimg8", cuda, False), frames)
    odom = _graph_odometry(proj, "rimg8", cuda)
    head = 1 + 2 * GRAPH_B  # frame 0, the eager batch, the captured one
    _run_graph_frames(odom, frames[:head])
    gc.collect()
    assert len(counters) == 1 and _block_state(counters[0]) == "active_allocated"
    fillers = _fill_free_small_blocks(cuda)
    graphed = _run_graph_frames(odom, frames[head:])
    assert np.array_equal(graphed[0], eager[0])
    for a, b in zip(graphed[1], eager[1]):
        assert torch.equal(a, b)
    # the rimg8 graph replays after the fill: batch 4 and the remainder
    assert graphed[2]["count.odometry.graph_replays"] == 3 + GRAPH_B + 2
    assert all(_block_state(c) == "active_allocated" for c in counters)
    assert fillers and bool(torch.cat(fillers).eq(7).all())


@pytest.mark.gpu
def test_graphed_elastic_odometry_equals_eager(cuda):
    """The CT-ICP profile's elastic step on rolling-shutter scans, batched
    by 4 (its configurations step one frame at a time, eagerly; a caller
    may batch them): replays equal to eager steps bit for bit, poses, map
    state and the begin and end pose surfaces, with 12 B1 launches a frame."""
    import dataclasses
    from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                          SyntheticDatasetLoader)
    from pylidar_slam_tpu_torch.eval import acceptance
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel
    n = 1 + 3 * GRAPH_B + 2
    loader = SyntheticDatasetLoader(SyntheticConfig(**dict(acceptance.ROLLING_SHUTTER_KW,
                                                           num_frames=n)))
    ds = loader.sequences()[0][0][0]
    frames = [ds[i] for i in range(n)]
    cfg = dataclasses.replace(acceptance.profile_configs()["ct_icp"], batch_size=GRAPH_B,
                              device=str(cuda))
    runs = []
    for graphed in (False, True):
        odom = ICPFrameToModel(cfg, projector=loader.projector())
        if not graphed:
            odom._step_graphed = lambda pts, msks: None
        run = _run_graph_frames(odom, frames)
        runs.append(run + ([odom.get_ct_relative_poses(s) for s in ("begin_pose", "end_pose")],))
    eager, graphed = runs
    assert np.array_equal(graphed[0], eager[0])
    for a, b in zip(graphed[1], eager[1]):
        assert torch.equal(a, b)
    for a, b in zip(graphed[4], eager[4]):
        assert np.array_equal(a, b)
    assert graphed[2] == {"count.odometry.graph_captures": 1,
                          "count.odometry.graph_replays": 3 + GRAPH_B + 2}
    assert eager[3] == graphed[3] == cfg.max_num_alignments * (n - 1)
