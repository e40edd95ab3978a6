"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: without a CUDA device every test here skips. On a machine
with one (no JAX needed):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu_torch.core import ScanBuffer, from_soa, to_soa
from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
    build_pipeline,
    params_from_config,
    settings_from_config,
)
from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
from autodriver_pointcloud_preprocessor_tpu_torch.models.presets import (
    PRODUCTION_128K_CONFIG,
)
from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build
from autodriver_pointcloud_preprocessor_tpu_torch.ops.compact import stream_compact_to
from autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean import (
    compact_rows,
    compact_rows_plain,
    masked_compact,
    masked_compact_plain,
    segmented_sums,
    segmented_sums_plain,
)
from autodriver_pointcloud_preprocessor_tpu_torch.ops.window_stats import window_stats

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("n,c,cap", [(1000, 1, 1000), (131072, 5, 65536), (4096, 8, 100)])
def test_masked_compact_kernel_is_bit_exact(cuda, n, c, cap):
    rng = _rng(n)
    vals = rng.normal(0, 10, (c, n)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.4
    vals[:, ~mask] = np.nan
    want = masked_compact(torch.from_numpy(vals), torch.from_numpy(mask), cap)
    before = _build.LAUNCHES["masked_compact"]
    got = masked_compact(torch.from_numpy(vals).to(cuda), torch.from_numpy(mask).to(cuda), cap)
    assert _build.LAUNCHES["masked_compact"] == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    ints = torch.from_numpy(vals).view(torch.int32)
    got_i = masked_compact(ints.to(cuda), torch.from_numpy(mask).to(cuda), cap)
    assert torch.equal(got_i.cpu(), masked_compact(ints, torch.from_numpy(mask), cap))


@pytest.mark.parametrize("n,density", [(4096, 0.13), (65536, 0.7), (5000, 0.0), (3000, 1.0)])
def test_segmented_sums_kernel_matches_plain(cuda, n, density):
    rng = _rng(n)
    flags = rng.uniform(size=n) < density
    vals = rng.normal(0, 3, (6, n)).astype(np.float32)
    want = segmented_sums(torch.from_numpy(vals), torch.from_numpy(flags))
    got = segmented_sums(torch.from_numpy(vals).to(cuda), torch.from_numpy(flags).to(cuda)).cpu()
    # the kernel and the CPU plain version both add each run in column order
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "kmode,wb,direction,k,moments",
    [("sweep", 2, 0, 8, True), ("csel", 1, 0, 20, True), ("csel", 0, 1, 20, False),
     ("sweep", 0, 0, 33, True), ("csel", 7, 0, 12, True)],
)
def test_window_stats_kernel_matches_plain(cuda, kmode, wb, direction, k, moments):
    rng = _rng(k + wb)
    n = 8192
    pts = (rng.uniform(-5, 5, (16, 3))[rng.integers(0, 16, n)]
           + rng.normal(0, 0.4, (n, 3))).astype(np.float32)
    pts = pts[np.lexsort(pts.T[::-1])]
    valid = rng.uniform(size=n) < 0.95
    valid[-300:] = False
    pts[rng.integers(0, n, 10)] = np.nan
    rows = [torch.from_numpy(np.ascontiguousarray(pts[:, i])) for i in range(3)]
    args = dict(k=k, window_blocks=wb, kmode=kmode, direction=direction, moments=moments)
    want = window_stats(*rows, torch.from_numpy(valid), 0.3, **args)
    got = [t.cpu() for t in window_stats(
        *(r.to(cuda) for r in rows), torch.from_numpy(valid).to(cuda), 0.3, **args
    )]
    v = torch.from_numpy(valid) & torch.from_numpy(np.isfinite(pts).all(1))
    rel = (got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-12)
    assert float((rel[v] <= 1e-5).float().mean()) >= 0.999
    assert torch.equal(got[1][v], want[1][v])
    assert torch.equal(got[2][0][v], want[2][0][v])
    torch.testing.assert_close(got[2][:, v], want[2][:, v], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize(
    "kmode,wb,direction,k", [("bisect", 1, 0, 20), ("bisect", 0, 1, 8), ("sweep", 1, 0, 20),
                             ("csel", 2, 0, 20)],
)
def test_window_stats_radius2_and_bisect_match_plain(cuda, kmode, wb, direction, k):
    rng = _rng(40 + k + wb)
    n = 8192
    pts = (rng.uniform(-5, 5, (16, 3))[rng.integers(0, 16, n)]
           + rng.normal(0, 0.4, (n, 3))).astype(np.float32)
    pts = pts[np.lexsort(pts.T[::-1])]
    valid = rng.uniform(size=n) < 0.95
    valid[-300:] = False
    valid[1024:1152] = False
    valid[1024:1029] = True  # an own block with fewer than k valid rows
    pts[rng.integers(0, n, 10)] = np.nan
    rows = [torch.from_numpy(np.ascontiguousarray(pts[:, i])) for i in range(3)]
    args = dict(k=k, window_blocks=wb, kmode=kmode, direction=direction, radius2=0.45)
    want = window_stats(*rows, torch.from_numpy(valid), 0.3, **args)
    before = _build.LAUNCHES["window_stats"]
    got = [t.cpu() for t in window_stats(
        *(r.to(cuda) for r in rows), torch.from_numpy(valid).to(cuda), 0.3, **args
    )]
    assert _build.LAUNCHES["window_stats"] == before + 1 and len(got) == 4
    v = torch.from_numpy(valid) & torch.from_numpy(np.isfinite(pts).all(1))
    rel = (got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-12)
    assert float((rel[v] <= 1e-5).float().mean()) >= 0.999
    assert torch.equal(got[1][v], want[1][v])
    assert torch.equal(got[2][0][v], want[2][0][v])
    assert torch.equal(got[3][v], want[3][v])  # the second radius's count
    # batched, a radius2 per scan: each element equals its unbatched launch
    rows2 = [torch.stack([r, r.flip(0)]).to(cuda) for r in rows]
    valid2 = torch.stack([torch.from_numpy(valid), torch.from_numpy(valid).flip(0)]).to(cuda)
    r2s = torch.tensor([0.45, 0.6], device=cuda)
    both = window_stats(*rows2, valid2, 0.3, **dict(args, radius2=r2s))
    for i in range(2):
        alone = window_stats(*(r[i] for r in rows2), valid2[i], 0.3, **dict(args, radius2=r2s[i]))
        for g, a in zip(both, alone):
            assert torch.equal(_bits(g[i]), _bits(a))


def test_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros(256, device=cuda)
    v = torch.ones(256, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        window_stats(x, x, x.cpu(), v, 0.1)
    with pytest.raises(ValueError):
        window_stats(x, x, x, v, 0.1, kmode="bisect", radius2=torch.ones(2, device=cuda))
    with pytest.raises(ValueError):
        masked_compact(torch.zeros((9, 256), device=cuda), v)
    with pytest.raises(ValueError):
        segmented_sums(torch.zeros((2, 512), device=cuda)[:, ::2], v)


def _bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_batched_kernels_equal_unbatched_launches(cuda):
    rng = _rng(3)
    b, n = 3, 8192
    vals = torch.from_numpy(rng.normal(0, 10, (b, 5, n)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(b, n)) < np.array([[0.3], [0.9], [0.0]]))
    flags = torch.from_numpy(rng.uniform(size=(b, n)) < np.array([[0.1], [0.7], [1.0]]))
    flags[1, 0] = False
    vals_d, mask_d, flags_d = vals.to(cuda), mask.to(cuda), flags.to(cuda)
    before = dict(_build.LAUNCHES)
    k1 = masked_compact(vals_d, mask_d, 4096)
    k2 = segmented_sums(vals_d, flags_d)
    assert _build.LAUNCHES["masked_compact"] == before["masked_compact"] + 1
    assert _build.LAUNCHES["segmented_sums"] == before["segmented_sums"] + 1
    assert torch.equal(_bits(k1), _bits(masked_compact_plain(vals, mask, 4096)))
    assert torch.equal(k2.cpu(), segmented_sums_plain(vals, flags))
    for i in range(b):
        assert torch.equal(_bits(k1[i]), _bits(masked_compact(vals_d[i], mask_d[i], 4096)))
        assert torch.equal(_bits(k2[i]), _bits(segmented_sums(vals_d[i], flags_d[i])))

    # K3: scan 1 is scan 0 reversed, so a flat row would reach across
    pts = (rng.uniform(-5, 5, (16, 3))[rng.integers(0, 16, n)]
           + rng.normal(0, 0.4, (n, 3))).astype(np.float32)
    pts = pts[np.lexsort(pts.T[::-1])]
    pts = np.stack([pts, pts[::-1]])
    rows = [torch.from_numpy(np.ascontiguousarray(pts[..., c])).to(cuda) for c in range(3)]
    valid = torch.ones((2, n), dtype=torch.bool, device=cuda)
    radius = torch.tensor([0.3, 0.45], device=cuda)
    for kmode, wb, direction, k in (("csel", 1, 0, 20), ("sweep", 2, 0, 8), ("csel", 0, 1, 20)):
        args = dict(k=k, window_blocks=wb, kmode=kmode, direction=direction)
        got = window_stats(*rows, valid, radius, **args)
        want = window_stats(*(r.cpu() for r in rows), valid.cpu(), radius.cpu(), **args)
        for i in range(2):
            alone = window_stats(*(r[i] for r in rows), valid[i], radius[i], **args)
            for g, a in zip(got, alone):
                assert torch.equal(_bits(g[i]), _bits(a))
            rel = (got[0][i].cpu() - want[0][i]).abs() / want[0][i].abs().clamp(min=1e-12)
            assert float((rel <= 1e-5).float().mean()) >= 0.999
            assert torch.equal(got[1][i].cpu(), want[1][i])
            assert torch.equal(got[2][i][0].cpu(), want[2][i][0])


def _scene_soa(seed, ground):
    rng = _rng(seed)
    n = 8000
    n_ground = int(n * ground)
    pts = np.column_stack([rng.uniform(-10, 10, (n, 2)), rng.normal(0, 0.03, n)])
    pts[n_ground:] = rng.normal(0, 1.0, (n - n_ground, 3)) + [3, 3, 1.5]
    return {"positions": pts.astype(np.float32),
            "intensity": rng.uniform(0, 255, n).astype(np.float32),
            "ring": rng.integers(0, 32, n).astype(np.uint16)}


_SLICE_CFG = {**PRODUCTION_128K_CONFIG, "downsample.pre_voxel_capacity": 4096,
              "downsample.max_points": 3584}


def test_process_batch_on_card_launches_once_per_batch(cuda):
    engine = Preprocessor(_SLICE_CFG)
    assert engine.device == cuda
    bufs = [from_soa(_scene_soa(i, g), capacity=8192)[0] for i, g in enumerate((0.6, 0.3, 0.5))]
    s = engine.settings
    u = torch.from_numpy(_rng(9).uniform(size=(3, s.num_iterations, s.ransac_n))
                         .astype(np.float32)).to(cuda)
    results = {}
    for sequential, per_batch in ((False, (1, 1, 2)), (True, (3, 3, 6))):
        _build.reset_launches()
        outs, planes = engine.process_batch(bufs, sequential=sequential, ground_uniforms=u)
        torch.cuda.synchronize()
        assert tuple(_build.LAUNCHES[k] for k in
                     ("masked_compact", "segmented_sums", "window_stats")) == per_batch
        assert planes.shape == (3, 4)
        results[sequential] = outs
    for a, b in zip(results[False], results[True]):
        assert torch.equal(a.mask, b.mask)
        assert torch.equal(_bits(a.positions[:, a.mask]), _bits(b.positions[:, b.mask]))


def test_pipeline_on_card_matches_cpu(cuda):
    soa = _scene_soa(1, 0.5)
    cfg = _SLICE_CFG
    settings = settings_from_config(cfg)
    run = build_pipeline(settings)
    u = torch.from_numpy(_rng(2).uniform(size=(settings.num_iterations, settings.ransac_n))
                         .astype(np.float32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        buf, meta = from_soa(soa, capacity=8192, device=dev)
        out, plane = run(buf, params_from_config(cfg, device=dev), None, u.to(dev))
        assert abs(float(plane[2])) > 0.99
        outs.append({tuple(r) for r in np.round(to_soa(out, meta)["positions"], 5).tolist()})
    jaccard = len(outs[0] & outs[1]) / len(outs[0] | outs[1])
    assert jaccard >= 0.99, jaccard


def _k2_case(name):
    """(values [C, N] or [B, C, N], run-start flags) of a K2 card case."""
    rng = _rng(len(name))
    if name == "b8_run_counts":
        n = 65536
        density = np.array([0.0, 0.01, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0])[:, None]
        flags = rng.uniform(size=(8, n)) < density
        return rng.normal(0, 3, (8, 6, n)).astype(np.float32), flags
    n = {"cross_tiles": 20000, "one_run": 65536, "all_starts": 65536, "ragged": 6 * 2048 + 77}[name]
    flags = {
        "cross_tiles": rng.uniform(size=n) < 0.2,
        "one_run": np.zeros(n, dtype=bool),
        "all_starts": np.ones(n, dtype=bool),
        "ragged": rng.uniform(size=n) < 0.3,
    }[name]
    if name == "cross_tiles":
        flags[3000:13001] = False  # one run over columns 2999..13000: six 2048-column CTA tiles
    return rng.normal(0, 3, (6, n)).astype(np.float32), flags


@pytest.mark.parametrize("name", ["cross_tiles", "one_run", "all_starts", "ragged", "b8_run_counts"])
def test_segmented_sums_one_launch_is_bit_equal(cuda, name):
    vals, flags = _k2_case(name)
    v, f = torch.from_numpy(vals), torch.from_numpy(flags)
    want = segmented_sums_plain(v, f)
    # leave NaN in the allocator's cache: the kernel must write every column
    torch.full((vals.size * 2,), float("nan"), device=cuda)
    vd, fd = v.to(cuda), f.to(cuda)
    before = _build.LAUNCHES["segmented_sums"]
    got = segmented_sums(vd, fd)
    assert _build.LAUNCHES["segmented_sums"] == before + 1
    assert torch.equal(_bits(got), _bits(want))
    if vals.ndim == 3:  # each element equals its unbatched launch
        for i in range(vals.shape[0]):
            assert torch.equal(_bits(got[i]), _bits(segmented_sums(vd[i], fd[i])))


_K1_DENSITIES = [0.0, 0.01, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0]


def _k1_case(name):
    """(live mask [N] or [B, N], capacity) of a K1 card case: tile edges for
    every tile width the kernel builds with (2048, 4096, 8192 columns)."""
    rng = _rng(len(name) + 100)
    if name == "b8_densities":
        return rng.uniform(size=(8, 131072)) < np.array(_K1_DENSITIES)[:, None], 65536
    n, cap = {"all_live": (20000, 20000), "none_live": (20000, 10000), "one_live": (20000, 4096),
              "runs_across_tiles": (40000, 40000), "ragged": (3 * 8192 + 77, 20000),
              "below_tile": (1000, 1000), "cap_below_live": (131072, 65536)}[name]
    mask = {"all_live": np.ones(n, bool), "none_live": np.zeros(n, bool)}.get(name)
    if name == "one_live":
        mask = np.zeros(n, bool)
        mask[8191] = True  # the last column of a tile at every width
    elif name == "runs_across_tiles":
        mask = np.zeros(n, bool)
        for lo, hi in ((2000, 2100), (4000, 12300), (16383, 16385), (24575, 40000)):
            mask[lo:hi] = True
    elif mask is None:
        mask = rng.uniform(size=n) < (0.6 if name == "cap_below_live" else 0.4)
    return mask, cap


def _k1_sources(mask, rng):
    """f32 [..., 3, N] with NaN on dead columns, int32 [..., N], f32 [..., N]."""
    lead, n = mask.shape[:-1], mask.shape[-1]
    pos = rng.normal(0, 10, lead + (3, n)).astype(np.float32)
    pos[np.broadcast_to(~mask[..., None, :], pos.shape)] = np.nan
    ints = rng.integers(-(2 ** 31), 2 ** 31 - 1, lead + (n,)).astype(np.int32)
    return [torch.from_numpy(pos), torch.from_numpy(ints),
            torch.from_numpy(rng.uniform(0, 255, lead + (n,)).astype(np.float32))]


@pytest.mark.parametrize("name", ["all_live", "none_live", "one_live", "runs_across_tiles", "ragged",
                                  "below_tile", "cap_below_live", "b8_densities"])
def test_k1_one_launch_is_bit_equal(cuda, name):
    mask_np, cap = _k1_case(name)
    sources = _k1_sources(mask_np, _rng(7))
    mask = torch.from_numpy(mask_np)
    want, want_mask = compact_rows_plain(sources, mask, cap)
    # leave NaN in the allocator's cache: the kernel must write every column
    torch.full((mask.numel() * 8,), float("nan"), device=cuda)
    src_d, mask_d = [s.to(cuda) for s in sources], mask.to(cuda)
    before = _build.LAUNCHES["masked_compact"]
    got, got_mask = compact_rows(src_d, mask_d, cap)
    assert _build.LAUNCHES["masked_compact"] == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))
    assert torch.equal(got_mask.cpu(), want_mask)
    # masked_compact: the same kernel over one tensor's rows
    stacked = torch.cat([sources[0].view(torch.int32), sources[1].unsqueeze(-2)], dim=-2)
    one = masked_compact(stacked.to(cuda), mask_d, cap)
    assert torch.equal(one.cpu(), masked_compact_plain(stacked, mask, cap))
    if mask.dim() == 2:  # each scan equals its unbatched launch
        for i in range(mask.shape[0]):
            alone, alone_mask = compact_rows([s[i] for s in src_d], mask_d[i], cap)
            assert all(torch.equal(_bits(g[i]), _bits(a)) for g, a in zip(got, alone))
            assert torch.equal(got_mask[i], alone_mask)


def _buffer_11_rows(rng, n):
    """A scan buffer whose rows are 5 float32 and 6 int32 ones: positions,
    intensity, ring, normals [3, N] and an int32 label [3, N]."""
    mask = rng.uniform(size=n) < 0.4
    pos = rng.normal(0, 20, (3, n)).astype(np.float32)
    pos[:, ~mask] = np.nan
    attrs = {
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "ring": rng.integers(0, 32, n).astype(np.int32),
        "normals": rng.normal(0, 1, (3, n)).astype(np.float32),
        "label": rng.integers(-(2 ** 31), 2 ** 31 - 1, (3, n)).astype(np.int32),
    }
    return ScanBuffer(torch.from_numpy(pos), torch.from_numpy(mask),
                      {k: torch.from_numpy(v) for k, v in attrs.items()})


def test_stream_compact_to_moves_11_rows_in_one_launch(cuda):
    n, cap = 131072, 65536
    buf = _buffer_11_rows(_rng(11), n)
    want = stream_compact_to(buf, cap)
    torch.full((n * 12,), float("nan"), device=cuda)
    dev = ScanBuffer(buf.positions.to(cuda), buf.mask.to(cuda),
                     {k: v.to(cuda) for k, v in buf.attributes.items()})
    before = _build.LAUNCHES["masked_compact"]
    got = stream_compact_to(dev, cap)
    assert _build.LAUNCHES["masked_compact"] == before + 1
    assert torch.equal(got.mask.cpu(), want.mask)
    assert torch.equal(_bits(got.positions), _bits(want.positions))
    for k, v in want.attributes.items():
        assert got.attributes[k].dtype == v.dtype and torch.equal(_bits(got.attributes[k]), _bits(v)), k


def test_stream_compact_to_rejects_a_non_contiguous_attribute(cuda):
    n = 4096
    buf = _buffer_11_rows(_rng(12), n)
    dev = ScanBuffer(buf.positions.to(cuda), buf.mask.to(cuda),
                     {"intensity": torch.zeros((n, 2), device=cuda)[:, 0]})
    assert not dev.attributes["intensity"].is_contiguous()
    with pytest.raises(ValueError):
        stream_compact_to(dev, 2048)


def _k3_rows(seed, n=8192):
    """Clustered rows in sort order, 5% invalid, a dead tail, NaN rows and
    one block with only 5 valid rows (fewer than k: csel's sparse path)."""
    rng = _rng(seed)
    pts = (rng.uniform(-5, 5, (16, 3))[rng.integers(0, 16, n)]
           + rng.normal(0, 0.4, (n, 3))).astype(np.float32)
    pts = pts[np.lexsort(pts.T[::-1])]
    valid = rng.uniform(size=n) < 0.95
    valid[-300:] = False
    valid[1024:1152] = False
    valid[1024:1029] = True
    pts[rng.integers(0, n, 10)] = np.nan
    rows = [torch.from_numpy(np.ascontiguousarray(pts[:, i])) for i in range(3)]
    return rows, torch.from_numpy(valid), torch.from_numpy(valid & np.isfinite(pts).all(1))


def _check_k3(cuda, rows, valid, v, args):
    want = window_stats(*rows, valid, 0.3, **args)
    before = _build.LAUNCHES["window_stats"]
    got = window_stats(*(r.to(cuda) for r in rows), valid.to(cuda), 0.3, **args)
    assert _build.LAUNCHES["window_stats"] == before + 1
    got = [t.cpu() for t in got]
    assert len(got) == len(want)
    rel = (got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-12)
    assert float((rel[v] <= 1e-5).float().mean()) >= 0.999
    assert torch.equal(got[1][v], want[1][v])
    assert torch.equal(got[2][0][v], want[2][0][v])
    torch.testing.assert_close(got[2][:, v], want[2][:, v], rtol=1e-4, atol=1e-3)
    if len(got) == 4:
        assert torch.equal(got[3][v], want[3][v])
    # batched (the rows and their reverse): each element equals its lone launch
    rows2 = [torch.stack([r, r.flip(0)]).to(cuda) for r in rows]
    valid2 = torch.stack([valid, valid.flip(0)]).to(cuda)
    both = window_stats(*rows2, valid2, 0.3, **args)
    for i in range(2):
        alone = window_stats(*(r[i] for r in rows2), valid2[i], 0.3, **args)
        for g, a in zip(both, alone):
            assert torch.equal(_bits(g[i]), _bits(a))


@pytest.mark.parametrize("kmode", ["sweep", "csel", "bisect"])
@pytest.mark.parametrize("radius2", [None, 0.45])
@pytest.mark.parametrize("moments", [True, False])
def test_window_stats_every_mode_matches_plain(cuda, kmode, radius2, moments):
    rows, valid, v = _k3_rows(7)
    _check_k3(cuda, rows, valid, v, dict(k=20, window_blocks=1, kmode=kmode, direction=0,
                                         moments=moments, radius2=radius2))


@pytest.mark.parametrize(
    "kmode,wb,direction,k",
    [("sweep", 1, 0, 64), ("csel", 1, 0, 64), ("bisect", 0, 1, 64), ("sweep", 7, 0, 20),
     ("csel", 7, 0, 33), ("bisect", 7, 0, 12), ("csel", 0, 0, 5), ("sweep", 2, 0, 1)],
)
def test_window_stats_wide_windows_and_large_k_match_plain(cuda, kmode, wb, direction, k):
    rows, valid, v = _k3_rows(11 + k + wb)
    _check_k3(cuda, rows, valid, v, dict(k=k, window_blocks=wb, kmode=kmode,
                                         direction=direction, moments=True, radius2=0.45))


# ------------------------------------------ bench_suite.py config 6 shapes ----

def test_k1_at_config6_shapes_is_bit_exact(cuda):
    # the 1M merged cloud's pre-voxel stage: 3 position rows, 1,048,576
    # columns, ~40% live after ground removal, into 524,288
    rng = _rng(61)
    n, cap = 1_048_576, 524_288
    vals = torch.from_numpy(rng.normal(0, 20, (3, n)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=n) < 0.4)
    vals[:, ~mask] = float("nan")
    outs, new_mask = compact_rows([vals.to(cuda)], mask.to(cuda), cap)
    want, want_mask = compact_rows_plain([vals], mask, cap)
    assert torch.equal(_bits(outs[0]), _bits(want[0])) and torch.equal(new_mask.cpu(), want_mask)


def test_k2_at_config6_shapes_is_bit_equal(cuda):
    # the wide-key voxel stage: [w, x*w, y*w, z*w] over 524,288 sorted rows,
    # ~360k voxels, the dead tail one run per column
    rng = _rng(62)
    n = 524_288
    flags = torch.from_numpy(rng.uniform(size=n) < 0.85)
    vals = torch.from_numpy(rng.normal(0, 20, (4, n)).astype(np.float32))
    vals[0] = 1.0
    flags[420_000:] = True
    vals[:, 420_000:] = 0.0
    got = segmented_sums(vals.to(cuda), flags.to(cuda))
    assert torch.equal(_bits(got), _bits(segmented_sums_plain(vals, flags)))


@pytest.mark.parametrize("direction", [0, 1])
def test_k3_at_config6_shapes_matches_plain(cuda, direction):
    # the fused neighbourhood of config 6: sweep, k=16, wb=1, moments, at
    # the 409,600-row bucket, ~360k live rows in curve order
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.window import _sorted_rows

    rng = _rng(63 + direction)
    n = 409_600
    pts = (rng.uniform(-40, 40, (300, 3))[rng.integers(0, 300, n)] * [1, 1, 0.05]
           + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    valid = torch.from_numpy(rng.uniform(size=n) < 0.88)
    sx, sy, sz, sv = _sorted_rows(torch.from_numpy(pts.T.copy()), valid, direction)
    args = dict(k=16, window_blocks=1, kmode="sweep", direction=direction, moments=True)
    want = window_stats(sx, sy, sz, sv, 0.1, **args)
    got = [t.cpu() for t in window_stats(sx.to(cuda), sy.to(cuda), sz.to(cuda), sv.to(cuda),
                                         0.1, **args)]
    rel = (got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-12)
    assert float((rel[sv] <= 1e-5).float().mean()) >= 0.999
    assert torch.equal(got[1][sv], want[1][sv])
    assert torch.equal(got[2][0][sv], want[2][0][sv])
    torch.testing.assert_close(got[2][:, sv], want[2][:, sv], rtol=1e-4, atol=1e-3)


def test_wide_voxel_keys_and_new_stage_orders_on_card_match_cpu(cuda):
    # the 'wide' voxel tier, ground last, the height cut and the three
    # downsamplers: the card's run equals the CPU's with the same draws
    soa = _scene_soa(4, 0.5)
    soa["positions"][:, :2] *= 12.0  # 240 m: beyond the 'box' tier at 0.08 m
    # a spinning sensor's order (by azimuth): the 4096 pre-voxel bucket
    # ahead of the last ground stage then keeps objects too
    order = np.argsort(np.arctan2(soa["positions"][:, 1], soa["positions"][:, 0]), kind="stable")
    soa = {k: v[order] for k, v in soa.items()}
    base = {**_SLICE_CFG, "roi_min": [-130.0, -130.0, -20.0], "roi_max": [130.0, 130.0, 20.0]}
    cases = [
        {},
        {"remove_ground.before_voxel": False},
        {"remove_ground.method": "height", "ground_plane": [0.0, 0.0, 1.0, 0.0]},
        {"downsample_method": "random"},
        {"downsample_method": "uniform"},
        {"downsample_method": "farthest_point", "downsample.num_samples": 1500},
    ]
    for extra in cases:
        cfg = {**base, **extra}
        settings = settings_from_config(cfg)
        assert settings.voxel_compact_keys == "wide"
        run = build_pipeline(settings)
        u = torch.from_numpy(_rng(5).uniform(size=(settings.num_iterations, settings.ransac_n))
                             .astype(np.float32))
        d = torch.from_numpy(_rng(6).uniform(size=4096).astype(np.float32))
        outs = []
        for dev in (cuda, torch.device("cpu")):
            buf, meta = from_soa(soa, capacity=8192, device=dev)
            out, plane = run(buf, params_from_config(cfg, device=dev), None, u.to(dev), d.to(dev))
            outs.append({tuple(r) for r in np.round(to_soa(out, meta)["positions"], 5).tolist()})
        jaccard = len(outs[0] & outs[1]) / max(len(outs[0] | outs[1]), 1)
        assert len(outs[1]) > 100 and jaccard >= 0.99, (extra, jaccard)


def _stream_fields(model, packets, pb, seed=0):
    """A field matrix of chip_smoke's random packets, padded to ``pb``
    packets, with packet times and count."""
    import chip_smoke
    from autodriver_pointcloud_preprocessor_tpu_torch.io.streaming import _split_packet_fields

    payloads, _ = chip_smoke.random_capture(model, packets, seed)
    fields = np.zeros((1176, pb), np.uint8)
    fields[:, :packets] = _split_packet_fields(payloads)
    stamp_off = np.zeros(pb, np.float32)
    stamp_off[:packets] = np.arange(packets, dtype=np.float32) * 1.3e-3
    return torch.from_numpy(fields), torch.from_numpy(stamp_off), torch.tensor(packets, dtype=torch.int32)


@pytest.mark.parametrize("model", ["VLP16", "HDL32E"])
def test_stream_decode_and_quantizer_on_card_match_cpu(cuda, model):
    """The packet decode on the card: mask, ring, intensity, time and
    distance equal to the CPU's, positions within 1e-4 m; the quantizer:
    one K1 launch, the count and box equal, rows within one quantum."""
    from autodriver_pointcloud_preprocessor_tpu_torch.io.compressor import device_quantizer
    from autodriver_pointcloud_preprocessor_tpu_torch.io.streaming import decode_fields

    tensors = _stream_fields(model, 120, 128)
    cpu = decode_fields(*tensors, 0.4, 110.0, model)
    card = decode_fields(*(t.to(cuda) for t in tensors), 0.4, 110.0, model)
    assert torch.equal(card.mask.cpu(), cpu.mask)
    for k in ("intensity", "ring", "time", "distance"):
        assert torch.equal(card.attributes[k].cpu(), cpu.attributes[k]), k
    assert float((card.positions.cpu() - cpu.positions)[:, cpu.mask].abs().max()) <= 1e-4
    quantize = device_quantizer(14)
    before = _build.LAUNCHES["masked_compact"]
    packed, meta = quantize(card, 1.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["masked_compact"] == before + 1
    cpu_packed, cpu_meta = quantize(cpu, 1.0)
    n = int(cpu_meta[0])
    assert float(meta[0]) == n > 0
    torch.testing.assert_close(meta.cpu()[1:], cpu_meta[1:], rtol=1e-6, atol=0)
    steps = (packed.cpu()[:3, :n].int() - cpu_packed[:3, :n].int()).abs()
    assert int(steps.max()) <= 1 and float((steps > 0).float().mean()) <= 1e-3
    assert torch.equal(packed.cpu()[3, :n], cpu_packed[3, :n])


def test_streaming_engine_on_card_matches_cpu(cuda, tmp_path):
    """bench_suite.py config 5 through StreamingEngine on the card and on
    the CPU: equal survivor counts per revolution, jaccard >= 0.99 on the
    quantization grid; one K1 (the quantizer's) and two K2 launches a
    revolution."""
    import chip_smoke
    from autodriver_pointcloud_preprocessor_tpu_torch.io.compressor import decompress_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.io.streaming import StreamingEngine

    path = str(tmp_path / "ring.pcap")
    chip_smoke.write_pcap(path, *chip_smoke.vlp16_ring_capture(160))
    engine = StreamingEngine(chip_smoke.CONFIG5, packet_bucket=80)
    _build.reset_launches()
    blobs = list(engine.replay_pcap(path))
    torch.cuda.synchronize()
    assert len(blobs) == 3
    assert (_build.LAUNCHES["masked_compact"], _build.LAUNCHES["segmented_sums"]) == (3, 6)
    cpu = list(StreamingEngine(chip_smoke.CONFIG5, packet_bucket=80, device="cpu").replay_pcap(path))
    for a, b in zip(blobs, cpu):
        j, steps, sizes, _ = chip_smoke.grid_jaccard(a, b, decompress_soa)
        assert sizes[0] == sizes[1] > 0 and j >= 0.99 and steps <= 1


def _node(device=None, **overrides):
    from autodriver_pointcloud_preprocessor_tpu_torch.runtime import (
        PointcloudPreprocessorNode,
        TopicBus,
    )

    bus = TopicBus()
    node = PointcloudPreprocessorNode(bus=bus, device=device,
                                      overrides={**PRODUCTION_128K_CONFIG, **overrides})
    outs = []
    bus.create_subscription(node.output_topic, outs.append)
    return node, bus.create_publisher(node.input_topic), outs


def test_node_on_card_matches_cpu(cuda):
    """The production node on the card (no device given) and on the CPU,
    one 128,000-point message each with the same RANSAC draws: one cloud
    each, launches 1/1/2 on the card, survivors by jaccard >= 0.99, >= 98%
    of common normals within 2 degrees."""
    import functools

    import chip_smoke
    from autodriver_pointcloud_preprocessor_tpu_torch.core import read_points

    msg = chip_smoke.velodyne_msg(0, 1.0)
    draws = torch.from_numpy(_rng(2).uniform(size=(64, 3)).astype(np.float32))
    outs = {}
    for device in (None, "cpu"):
        node, pub, outs[device] = _node(device=device)
        node.engine.process_buffer = functools.partial(
            node.engine.process_buffer, ground_uniforms=draws.to(node.engine.device))
        _build.reset_launches()
        pub.publish(msg)
        assert node.frame_count == 1
        if device is None:
            torch.cuda.synchronize()
            assert node.engine.device == cuda
            assert tuple(_build.LAUNCHES[k] for k in chip_smoke.KERNELS) == (1, 1, 2)

    def survivors(m):
        p = read_points(m)
        return chip_smoke.survivor_normals({
            "positions": np.stack([p["x"], p["y"], p["z"]], 1),
            "normals": np.stack([p["normal_x"], p["normal_y"], p["normal_z"]], 1)})

    a, c = survivors(outs[None][0]), survivors(outs["cpu"][0])
    common = a.keys() & c.keys()
    assert len(common) / len(a.keys() | c.keys()) >= 0.99
    cos = np.array([abs(float(np.dot(a[p], c[p]))) for p in common])
    assert float((cos >= np.cos(np.deg2rad(2.0))).mean()) >= 0.98


def test_concatenator_on_card_matches_cpu(cuda):
    """Three sensors with their own time bases and extrinsics: the card's
    merged cloud is byte-equal to the CPU concatenator's."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import Time
    from autodriver_pointcloud_preprocessor_tpu_torch.io.loader import soa_to_pointcloud2
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.linalg import se3_matrix
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel import PointcloudConcatenatorNode
    from autodriver_pointcloud_preprocessor_tpu_torch.runtime import TopicBus

    rng = _rng(5)
    topics = ["/a", "/b", "/c"]
    ext = {t: se3_matrix(tuple(rng.normal(0, 10, 3)), tuple(rng.normal(size=4))).numpy() for t in topics}
    msgs = []
    for i in range(3):
        n = 40_000 + 1000 * i
        t = 50.0 + 0.013 * i
        soa = {"positions": rng.normal(0, 20, (n, 3)).astype(np.float32),
               "intensity": rng.uniform(0, 255, n).astype(np.float32),
               "time": t + np.sort(rng.uniform(0, 0.1, n))}
        msgs.append(soa_to_pointcloud2(soa, frame_id=f"s{i}", stamp=Time.from_float(t)))
    merged = {}
    for device in ("cuda", "cpu"):
        bus = TopicBus()
        node = PointcloudConcatenatorNode(bus, topics, extrinsics=ext, device=None if device == "cuda" else "cpu")
        assert node.device.type == device
        merged[device] = []
        bus.create_subscription("/points/concatenated", merged[device].append)
        for topic, msg in zip(topics, msgs):
            bus.create_publisher(topic).publish(msg)
    assert len(merged["cuda"]) == len(merged["cpu"]) == 1
    assert merged["cuda"][0].width == 123_000
    assert merged["cuda"][0].data == merged["cpu"][0].data


def test_preprocessor_cli_defaults_to_the_card(cuda, tmp_path):
    """``preprocessor_main`` with no ``--device`` runs its scans through
    the kernels on cuda:0."""
    import json

    import chip_smoke
    from autodriver_pointcloud_preprocessor_tpu_torch import cli
    from autodriver_pointcloud_preprocessor_tpu_torch.io.pcd import read_point_cloud, write_point_cloud

    src = tmp_path / "in"
    src.mkdir()
    for i in range(2):
        write_point_cloud(str(src / f"{i:04d}.pcd"), chip_smoke.bench_soa(i))
    params = tmp_path / "p.json"
    params.write_text(json.dumps(PRODUCTION_128K_CONFIG))
    _build.reset_launches()
    assert cli.preprocessor_main([str(src), "-o", str(tmp_path / "out"), "--params", str(params)]) == 0
    torch.cuda.synchronize()
    assert tuple(_build.LAUNCHES[k] for k in chip_smoke.KERNELS) == (2, 2, 4)
    cloud = read_point_cloud(str(tmp_path / "out" / "00000001.pcd"))
    assert 0 < cloud["positions"].shape[0] < 50_000 and cloud["normals"].shape[1] == 3


def test_node_with_use_gpu_false_runs_on_the_card(cuda):
    """``use_gpu`` is reported, never a device switch: a node constructed
    with it False, and reconfigured either way, stays on cuda:0."""
    import chip_smoke
    from autodriver_pointcloud_preprocessor_tpu_torch.runtime import Parameter

    node, pub, outs = _node(use_gpu=False)
    assert node.use_gpu is False and node.engine.device == cuda
    for value in (True, False):
        assert node.set_parameters([Parameter("use_gpu", value)])[0].successful
        assert node.engine.device == cuda and node.engine.params.voxel_size.device == cuda
    _build.reset_launches()
    pub.publish(chip_smoke.velodyne_msg(1, 2.0))
    torch.cuda.synchronize()
    assert node.frame_count == 1 and len(outs) == 1
    assert tuple(_build.LAUNCHES[k] for k in chip_smoke.KERNELS) == (1, 1, 2)


#: the sharded path's knobs: ``__graft_entry__._full_settings()``
SHARDED_SETTINGS = dict(
    remove_statistical_outliers=True, nb_neighbors=16, estimate_normals=True, max_neighbors=16,
    remove_ground=True, ransac_n=3, num_iterations=64, knn_method="window",
    ground_before_voxel=True, voxel_compact_keys=True, knn_kmode="csel", window_blocks=(1, 0),
    normals_merge_passes=False,
)


def _sharded_rank(rank, world, store, out, device):
    """One gloo rank of ``test_sharded_gloo_ranks_on_card_match_cpu``: the
    sharded pipeline on its slab of a 16,000-point scene at capacity
    16,384, its own RANSAC draws; rank 0 writes the gathered output and
    every rank's launches to ``out``."""
    import datetime

    import torch.distributed as dist

    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        PipelineParams, PipelineSettings,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel import sharding as sh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        rng = _rng(16)
        ground = np.column_stack([rng.uniform(-15, 15, (2, 10_000)).T, rng.normal(0, 0.03, 10_000)])
        obj = rng.uniform(-12, 12, (6000, 3)) * [1, 1, 0.1] + [0, 0, 1.5] + rng.normal(0, 0.3, (6000, 3))
        buf, _ = from_soa({"positions": np.vstack([ground, obj]).astype(np.float32)},
                          capacity=16384, device=device)
        params = PipelineParams.make(voxel_size=0.1, distance_threshold=0.1, search_radius=0.5,
                                     device=device)
        mesh = sh.make_mesh()
        draws = torch.from_numpy(_rng(20 + rank).uniform(size=(64 // world, 3)).astype(np.float32))
        run = sh.build_sharded_pipeline(PipelineSettings(**SHARDED_SETTINGS), mesh)
        local = sh.shard_buffer(buf, mesh)
        _build.reset_launches()
        local, plane = run(local, params, None, draws.to(device))
        launches = torch.tensor([_build.LAUNCHES[k] for k in
                                 ("masked_compact", "segmented_sums", "window_stats")])
        launches = torch.stack(sh._all_gather(launches, mesh.get_group("point")))
        full = sh.unshard_buffer(local, mesh)
        if rank == 0:
            np.savez(out, pos=full.positions.cpu().numpy(), mask=full.mask.cpu().numpy(),
                     normals=full.attributes["normals"].cpu().numpy(), plane=plane.cpu().numpy(),
                     launches=launches.numpy(), device=str(plane.device))
    finally:
        dist.destroy_process_group()


def test_sharded_gloo_ranks_on_card_match_cpu(cuda, tmp_path):
    """2 gloo ranks on cuda:0 against the same 2 ranks on the CPU with the
    same draws, 16,384 points: each card rank launches K2 once and K3
    twice (no K1: the sharded run has no pre-voxel bucket), survivors by
    jaccard >= 0.99, >= 98% of common normals within 2 degrees."""
    import torch.multiprocessing as mp

    import chip_smoke

    _build.load_library()  # built once here, loaded by the ranks
    outs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.npz"
        mp.start_processes(_sharded_rank, args=(2, str(tmp_path / f"store_{device}"), str(out), device),
                           nprocs=2, join=True, start_method="spawn")
        with np.load(out) as z:
            outs[device] = {k: z[k] for k in z.files}
    card, cpu = outs["cuda"], outs["cpu"]
    assert str(card["device"]) == "cuda:0" and str(cpu["device"]) == "cpu"
    assert card["launches"].tolist() == [[0, 1, 2]] * 2
    assert cpu["launches"].tolist() == [[0, 0, 0]] * 2
    assert abs(card["plane"][2]) > 0.99
    np.testing.assert_allclose(card["plane"], cpu["plane"], atol=1e-4)

    def survivors(o):
        m = o["mask"]
        return chip_smoke.survivor_normals({"positions": o["pos"][:, m].T, "normals": o["normals"][:, m].T})

    a, c = survivors(card), survivors(cpu)
    common = a.keys() & c.keys()
    assert len(common) > 1000
    assert len(common) / len(a.keys() | c.keys()) >= 0.99
    cos = np.array([abs(float(np.dot(a[p], c[p]))) for p in common])
    assert float((cos >= np.cos(np.deg2rad(2.0))).mean()) >= 0.98


# ---- captured programs (models/graphs.py) ------------------------------------

def _same_tree(a, b):
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def _draws(settings, batch=None, seed=9):
    shape = (settings.num_iterations, settings.ransac_n)
    u = _rng(seed).uniform(size=shape if batch is None else (batch,) + shape)
    return torch.from_numpy(u.astype(np.float32))


def test_graphed_engine_equals_eager_on_card(cuda):
    """Single scans and B=8 batches (vmapped and sequential) replayed from
    captured programs: bit-equal to ``build_pipeline`` run eagerly with
    the same draws, with the same launch counts."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import stack_buffers

    engine = Preprocessor(_SLICE_CFG)
    run = build_pipeline(engine.settings)
    bufs = [from_soa(_scene_soa(i, 0.6), capacity=8192)[0] for i in range(8)]
    u = _draws(engine.settings, batch=8).to(cuda)
    for _ in range(2):  # the capture, then a replay
        _build.reset_launches()
        got = engine.process_buffer(bufs[0], ground_uniforms=u[0])
        graphed = dict(_build.LAUNCHES)
        _build.reset_launches()
        assert _same_tree(got, run(bufs[0], engine.params, None, u[0]))
        assert graphed == dict(_build.LAUNCHES) == {
            "masked_compact": 1, "segmented_sums": 1, "window_stats": 2}
    outs, planes = engine.process_batch(bufs, ground_uniforms=u)
    assert _same_tree((stack_buffers(outs), planes),
                      run(stack_buffers(bufs), engine.params, None, u))
    outs, planes = engine.process_batch(bufs, sequential=True, ground_uniforms=u)
    runs = [run(b, engine.params, None, u[i]) for i, b in enumerate(bufs)]
    assert _same_tree((outs, planes), ([r[0] for r in runs], torch.stack([r[1] for r in runs])))


def test_graphed_streaming_equals_eager_on_card(cuda, tmp_path, monkeypatch):
    """Config 5 replays, single and batched, from captured programs: blobs
    byte-equal to the same engine run eagerly."""
    import chip_smoke
    from autodriver_pointcloud_preprocessor_tpu_torch.io.streaming import StreamingEngine
    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs

    path = str(tmp_path / "ring.pcap")
    chip_smoke.write_pcap(path, *chip_smoke.vlp16_ring_capture(300))
    graphed = StreamingEngine(chip_smoke.CONFIG5, packet_bucket=80)
    single, batch = list(graphed.replay_pcap(path)), list(graphed.replay_pcap(path, batch=4))
    monkeypatch.setattr(graphs, "captures", lambda device: False)
    eager = StreamingEngine(chip_smoke.CONFIG5, packet_bucket=80)
    assert single == list(eager.replay_pcap(path)) == batch
    assert list(eager.replay_pcap(path, batch=4)) == batch


def test_reconfigure_and_tf_after_capture_on_card(cuda):
    """A numeric reconfigure and a TF replacing a TF after the capture reach
    the replay: each result equals a fresh engine's eager run."""
    engine = Preprocessor(_SLICE_CFG)
    buf = from_soa(_scene_soa(3, 0.5), capacity=8192)[0]
    u = _draws(engine.settings).to(cuda)
    engine.process_buffer(buf, ground_uniforms=u)
    cfg = {**_SLICE_CFG, "voxel_size": 0.08}
    engine.update_config({"voxel_size": 0.08})

    def eager(tf=None):
        run = build_pipeline(settings_from_config({**cfg, "_has_tf": tf is not None}))
        return run(buf, params_from_config(cfg, tf, cuda), None, u)

    assert _same_tree(engine.process_buffer(buf, ground_uniforms=u), eager())
    tf = np.eye(4, dtype=np.float32)
    for shift in (0.0, 0.5):
        tf[:3, 3] = (1.0, shift, 1.9)
        engine.set_tf_matrix(tf)
        assert _same_tree(engine.process_buffer(buf, ground_uniforms=u), eager(tf))


def test_pipelined_node_outputs_are_not_overwritten_on_card(cuda):
    """The pipelined node resolves scan N after scan N+1's replay: its
    clouds equal the static node's, byte for byte."""
    import chip_smoke

    msgs = [chip_smoke.velodyne_msg(i, 1.0 + 0.1 * i) for i in range(4)]
    clouds = []
    for pipelined in (False, True):
        node, pub, outs = _node()
        node.pipelined = pipelined
        for m in msgs:
            pub.publish(m)
        if pipelined:
            node.flush_pipeline()
        clouds.append([o.data for o in outs])
    assert len(clouds[0]) == len(msgs) and clouds[0] == clouds[1]


def test_replay_credits_the_launches_the_profiler_sees(cuda):
    """One replay of the production slice's program runs exactly the K1,
    K2 and K3 kernels it credits to the launch counts."""
    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import draw_uniforms

    engine = Preprocessor(_SLICE_CFG)
    buf = from_soa(_scene_soa(4, 0.6), capacity=8192)[0]
    u = _draws(engine.settings).to(cuda)
    engine.process_buffer(buf, ground_uniforms=u)
    draws = draw_uniforms(engine.settings, (), 8192, None, cuda, u)
    prog = graphs.lookup(("engine", "scan", engine.settings), (buf, engine.params, draws))
    assert prog.credits == {"masked_compact": 1, "segmented_sums": 1, "window_stats": 2}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):  # the first trace warms the tracer up
        _build.reset_launches()
        with torch.profiler.profile(activities=acts) as prof:
            prog(buf, engine.params, draws)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {k: sum(f"{k}_kernel" in n for n in names) for k in prog.credits}
    assert seen == prog.credits == dict(_build.LAUNCHES)


def _on(tree, device):
    from torch.utils._pytree import tree_map

    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def test_engine_on_a_second_card_matches_the_first(cuda):
    """An engine on cuda:1 while cuda:0 is current: its replays and its
    eager runs equal an engine's on cuda:0, bit for bit (every kernel
    launch, capture and replay enters its tensors' device)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import draw_uniforms

    torch.cuda.set_device(0)
    second = torch.device("cuda:1")
    soa = _scene_soa(5, 0.6)
    outs = {}
    for dev in (cuda, second):
        engine = Preprocessor(_SLICE_CFG, device=dev)
        buf = from_soa(soa, capacity=8192, device=dev)[0]
        u = _draws(engine.settings).to(dev)
        _build.reset_launches()
        graphed = [engine.process_buffer(buf, ground_uniforms=u) for _ in range(2)]
        draws = draw_uniforms(engine.settings, (), 8192, None, dev, u)
        eager = build_pipeline(engine.settings)(buf, engine.params, None, *draws)
        assert dict(_build.LAUNCHES) == {"masked_compact": 3, "segmented_sums": 3,
                                         "window_stats": 6}
        assert graphed[0][0].mask.device == dev and torch.cuda.current_device() == 0
        outs[dev] = _on((graphed, eager), "cpu")
    assert _same_tree(outs[cuda], outs[second])
    assert _same_tree(outs[cuda][0][0], outs[cuda][1])


def test_profile_mode_stage_programs_equal_eager_stages_on_card(cuda):
    """Profile mode replays one program a stage: bit-equal to the stages
    run eagerly with the same draws, with the production slice's
    launches (1/1/2) and one timing key a stage."""
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        STAGE_TIMING_KEYS,
        draw_uniforms,
        stage_functions,
    )

    engine = Preprocessor(_SLICE_CFG, profile=True)
    buf = from_soa(_scene_soa(6, 0.6), capacity=8192)[0]
    u = _draws(engine.settings).to(cuda)
    stages = stage_functions(engine.settings, separate_stages=True)
    draws = draw_uniforms(engine.settings, (), 8192, None, cuda, u)
    for _ in range(2):  # the captures, then the replays
        _build.reset_launches()
        got = engine.process_buffer(buf, ground_uniforms=u)
        assert dict(_build.LAUNCHES) == {"masked_compact": 1, "segmented_sums": 1,
                                         "window_stats": 2}
        want, plane = buf, None
        for _, fn in stages:
            want, aux = fn(want, engine.params, None, *draws)
            plane = aux if aux is not None else plane
        assert _same_tree(got, (want, plane))
    assert set(engine.processing_times) == {STAGE_TIMING_KEYS[n] for n, _ in stages} | {
        "preprocessing_time"}


def test_graphed_merge_equals_eager_on_card(cuda, monkeypatch):
    """The concatenator's merge replayed from its program publishes the
    clouds the eager merge publishes, byte for byte."""
    import chip_smoke
    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.linalg import se3_matrix
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel import PointcloudConcatenatorNode
    from autodriver_pointcloud_preprocessor_tpu_torch.runtime import TopicBus

    topics = ["/a", "/b", "/c"]
    ext = {t: se3_matrix((50.0 * i, 0.0, 0.0), (0.0, 0.0, 0.5, 0.866)).numpy()
           for i, t in enumerate(topics)}
    clouds = []
    for graphed in (True, False):
        monkeypatch.setattr(graphs, "captures", lambda device, g=graphed: g and device.type == "cuda")
        bus, outs = TopicBus(), []
        PointcloudConcatenatorNode(bus, topics, extrinsics=ext, mode="sync", slop=0.05)
        bus.create_subscription("/points/concatenated", outs.append)
        for r in range(2):
            for i, t in enumerate(topics):
                bus.create_publisher(t).publish(chip_smoke.velodyne_msg(10 * r + i, 3.0 + r + 0.01 * i))
        clouds.append([o.data for o in outs])
    assert len(clouds[0]) == 2 and clouds[0] == clouds[1]


def test_sharded_nccl_step_is_captured_and_equals_eager(cuda, tmp_path):
    """A world of one NCCL rank on cuda:0: ``build_sharded_pipeline``
    replays a captured step, bit-equal to the eager body with the same
    draws, with the same launches (0/1/2) and collectives a step."""
    import torch.distributed as dist

    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import PipelineParams
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import PipelineSettings
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel import sharding as sh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        mesh = sh.make_mesh()
        settings = PipelineSettings(
            remove_statistical_outliers=True, nb_neighbors=16, estimate_normals=True,
            max_neighbors=16, remove_ground=True, ransac_n=3, num_iterations=64,
            knn_method="window", ground_before_voxel=True, post_downsample_capacity=4096)
        params = PipelineParams.make(voxel_size=0.1, distance_threshold=0.1, device=cuda)
        local = sh.shard_buffer(from_soa(_scene_soa(7, 0.6), capacity=8192)[0], mesh)
        step = sh.build_sharded_pipeline(settings, mesh)
        eager = sh.make_local_run(settings, mesh=mesh)
        assert sh.captures_step(mesh.get_group("point"), cuda)
        u = _draws(settings).to(cuda)
        for _ in range(2):  # the capture, then a replay
            counts = []
            for fn in (step, eager):
                _build.reset_launches()
                sh.reset_collectives()
                out = fn(local, params, None, u)
                counts.append((dict(_build.LAUNCHES), dict(sh.COLLECTIVES)))
                if fn is step:
                    got = out
            assert _same_tree(got, out) and counts[0] == counts[1]
            assert counts[0][0] == {"masked_compact": 0, "segmented_sums": 1, "window_stats": 2}
        assert graphs.programs()[-1].replays == 2  # the step's program, used last
    finally:
        graphs.clear()
        dist.destroy_process_group()
