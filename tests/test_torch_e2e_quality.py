"""The port's end-to-end quality floor: tests/test_e2e_quality.py in the
port alone.

The shipped window-kNN presets against the same pipeline with
``knn_method='exact'`` (exact kNN for the outlier statistics and the
normals), on the density-matched 8000-point scene at capacity 8192: the
survivor jaccard must stay >= 0.98, the reference's floor. The port's
window path is K3's plain version on the CPU, the kernel's contract.
"""
import dataclasses

import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa
from autodriver_pointcloud_preprocessor_tpu_torch.models import build_pipeline
from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
    params_from_config,
    settings_from_config,
)
from autodriver_pointcloud_preprocessor_tpu_torch.models.presets import (
    PRODUCTION_128K_CONFIG,
    PRODUCTION_128K_QUALITY_CONFIG,
)


def _scene_density_matched(n: int, seed: int = 0) -> np.ndarray:
    """bench._scene shrunk to +-10 m, so that n=8000 points carry the areal
    density (~20 pts/m^2) of the production 128k scan over +-40 m."""
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.6)
    n_obj = n - n_ground
    ground = np.column_stack(
        [rng.uniform(-10, 10, (2, n_ground)).T, rng.normal(0, 0.03, n_ground)]
    )
    centers = rng.uniform(-7.5, 7.5, (24, 3)) * [1, 1, 0] + [0, 0, 1.5]
    obj = centers[rng.integers(0, len(centers), n_obj)] + rng.normal(0, 0.8, (n_obj, 3))
    pts = np.vstack([ground, obj]).astype(np.float32)
    pts[:: max(n // 200, 1)] = np.nan
    return pts


@pytest.mark.parametrize(
    "config", [PRODUCTION_128K_CONFIG, PRODUCTION_128K_QUALITY_CONFIG],
    ids=["production", "quality"],
)
def test_e2e_survivor_jaccard_floor(config):
    n_points, capacity = 8000, 8192
    rng = np.random.default_rng(1)
    soa = {
        "positions": _scene_density_matched(n_points),
        "intensity": rng.uniform(0, 255, n_points).astype(np.float32),
        "ring": rng.integers(0, 32, n_points).astype(np.uint16),
    }
    settings = settings_from_config(config)
    params = params_from_config(config, device="cpu")
    exact_settings = dataclasses.replace(
        settings, knn_method="exact", window_blocks=1, knn_d2mode="highest", knn_kmode="sweep",
    )
    draws = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(settings.num_iterations, settings.ransac_n)).astype(np.float32))

    def survivor_set(s):
        buf, _ = from_soa(soa, capacity=capacity, device="cpu")
        out, _plane = build_pipeline(s)(buf, params, None, draws)
        m = out.mask.numpy()
        assert m.sum() > 1000, "pipeline nearly emptied the scan"
        return {tuple(r) for r in np.round(out.positions.numpy()[:, m].T, 5).tolist()}

    sw = survivor_set(settings)
    se = survivor_set(exact_settings)
    jaccard = len(sw & se) / max(len(sw | se), 1)
    print(f"e2e survivor jaccard {jaccard:.5f} ({len(sw)} window, {len(se)} exact survivors)")
    assert jaccard >= 0.98, f"e2e survivor jaccard {jaccard:.4f} < 0.98"
