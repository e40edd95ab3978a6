"""Standalone preprocessing engine (non-ROS API).

Port of ``autodriver_pointcloud_preprocessor_tpu/models/preprocessor.py``.
``Preprocessor`` owns the config, the pipeline for its settings, the
random generator and the per-stage timing dict; the runtime node and the
streaming engine wrap it.

Batches: ``process_batch`` runs a list of same-capacity buffers either as
one batched run (every stage over a leading scan axis, each kernel
launched as often as for one scan: the reference's ``vmap``) or as a loop
of single-scan runs on one stream (the reference's ``lax.map``).

Execution: on a CUDA card the production mode (``profile=False``) runs
every scan, vmapped batch and sequential batch as one captured program
(``models/graphs.py``), as the reference runs one ``jit`` program: the
first call of a (settings, capacity, attribute schema, batch shape, mode)
captures it, later calls replay it. The random draws are taken ahead of
the replay from the engine's generator, in the order an eager run takes
them (``pipeline.draw_uniforms``). Profile mode replays one program a
(settings, stage, input shapes) instead, as the reference jits each
stage (``_stage_jit``), with the draws taken ahead the same way and a
sync after each stage, so each stage's time is its own. On the CPU the
stages run eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.scan import (
    ScanBuffer,
    from_soa,
    resolve_device,
    stack_buffers,
    to_soa,
    unstack_buffer,
    valid_count,
)
from ..core.timing import StageTimer, get_current_time, get_time_difference
from . import graphs
from .pipeline import (
    STAGE_TIMING_KEYS,
    PipelineParams,
    PipelineSettings,
    build_pipeline,
    draw_uniforms,
    params_from_config,
    settings_from_config,
    stage_functions,
)

__all__ = ["Preprocessor"]


def _plane_metadata(plane: torch.Tensor) -> Optional[np.ndarray]:
    p = plane.cpu().numpy()
    return None if np.isnan(p).any() else p


class Preprocessor:
    """Configurable scan preprocessing engine.

    Args:
        config: flat dict using the reference's dotted parameter names
            (missing keys -> reference defaults).
        profile: when True, stages run one at a time with a device
            synchronisation after each, so ``processing_times`` carries
            real per-stage wall times under the reference's keys. When
            False only ``preprocessing_time`` is recorded (the production
            mode; captured programs on a CUDA card).
        seed: seed of the engine's generator (the RANSAC draws and the
            random downsampler's, drawn anew for every scan).
        device: where the engine's tensors live (default ``cuda:0``;
            raises without a card unless a device is given).
        pallas_ok: ``PipelineSettings.pallas_ok``, a settings field that no
            config key reaches: False runs the window stages on the
            reference's XLA route (``ops/window.py``, no K3). It holds
            across ``update_config`` and ``set_tf_matrix``.
    """

    def __init__(
        self,
        config: Optional[Dict[str, object]] = None,
        profile: bool = False,
        seed: int = 0,
        device: torch.device | str | None = None,
        pallas_ok: bool = True,
    ):
        self.config: Dict[str, object] = dict(config or {})
        self.pallas_ok = pallas_ok
        self.profile = profile
        self.device = resolve_device(device)
        self.processing_times: Dict[str, float] = {}
        self._timer = StageTimer(self.processing_times)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._tf_matrix: Optional[np.ndarray] = None
        self._rebuild()

    # -- configuration --------------------------------------------------------

    def _rebuild(self) -> None:
        cfg = dict(self.config)
        cfg["_has_tf"] = self._tf_matrix is not None
        self.settings: PipelineSettings = dataclasses.replace(
            settings_from_config(cfg), pallas_ok=self.pallas_ok)
        # raises here, not at the next scan, for a stage the port lacks
        self._run = build_pipeline(self.settings)
        self.params: PipelineParams = params_from_config(cfg, self._tf_matrix, self.device)

    def update_config(self, delta: Dict[str, object]) -> None:
        """Apply a config change. A delta that fails validation, or asks
        for a stage the port does not have, is ROLLED BACK: the previous
        config stays live and the error propagates."""
        old = dict(self.config)
        self.config.update(delta)
        try:
            self._rebuild()
        except Exception:
            self.config = old
            self._rebuild()
            raise

    def set_tf_matrix(self, matrix: Optional[np.ndarray]) -> None:
        """Install (or clear) the sensor->robot homogeneous transform.

        A node with a TF that is not static installs one on every scan:
        when a transform replaces another, the settings and the pipeline
        stay and only the matrix is copied to the device (one copy, not a
        rebuild of every parameter)."""
        had_tf = self._tf_matrix is not None
        self._tf_matrix = None if matrix is None else np.asarray(matrix, np.float32)
        if had_tf and matrix is not None:
            self.params = dataclasses.replace(
                self.params, tf_matrix=torch.as_tensor(self._tf_matrix, device=self.device)
            )
        else:
            self._rebuild()

    # -- processing -----------------------------------------------------------

    def process_soa(
        self,
        soa: Dict[str, np.ndarray],
        metadata: Optional[dict] = None,
        capacity: Optional[int] = None,
    ) -> Tuple[Dict[str, np.ndarray], dict]:
        """Host SoA in -> processed host SoA out.

        Records the reference's timing keys: ``tensor_transfer`` (H2D +
        padding), per-stage keys in profile mode, ``preprocessing_time``
        and ``device_to_host``.
        """
        start = get_current_time(monotonic=True)
        buf, metadata = from_soa(soa, capacity=capacity, metadata=metadata, device=self.device)
        self.processing_times["tensor_transfer"] = get_time_difference(
            start, get_current_time(monotonic=True)
        )

        buf, plane = self.process_buffer(buf)

        start = get_current_time(monotonic=True)
        out = to_soa(buf, metadata)
        self.processing_times["device_to_host"] = get_time_difference(
            start, get_current_time(monotonic=True)
        )
        if self.settings.estimate_normals:
            metadata["has_normals"] = True
        metadata["ground_plane_estimate"] = _plane_metadata(plane)
        return out, metadata

    def process_soa_async(self, soa, metadata=None, capacity=None):
        """Enqueue a scan and return a resolver: calling it copies the
        result to the host and yields ``(out_soa, metadata)``."""
        buf, metadata = from_soa(soa, capacity=capacity, metadata=metadata, device=self.device)
        buf, plane = self.process_buffer(buf)

        def resolve():
            out = to_soa(buf, metadata)
            if self.settings.estimate_normals:
                metadata["has_normals"] = True
            metadata["ground_plane_estimate"] = _plane_metadata(plane)
            return out, metadata

        return resolve

    def process_buffer(
        self,
        buf: ScanBuffer,
        ground_uniforms: Optional[torch.Tensor] = None,
        downsample_uniforms: Optional[torch.Tensor] = None,
    ) -> Tuple[ScanBuffer, torch.Tensor]:
        """Device buffer in -> device buffer and plane float32[4] out.

        ``ground_uniforms`` float32[num_iterations, ransac_n] and
        ``downsample_uniforms`` float32[capacity] replace the generator's
        RANSAC and random-downsampler draws (the tests feed the
        reference's)."""
        start = get_current_time(monotonic=True)
        draws = (ground_uniforms, downsample_uniforms)
        if self.profile:
            buf, plane = self._run_profiled(buf, *draws)
        elif graphs.captures(self.device):
            draws = self._draw(buf.batch_shape, buf.capacity, *draws)
            buf, plane = self._replay("scan", buf, draws)
        else:
            buf, plane = self._run(buf, self.params, self.generator, *draws)
        self.processing_times["preprocessing_time"] = get_time_difference(
            start, get_current_time(monotonic=True)
        )
        return buf, plane

    def process_batch(
        self,
        bufs: Sequence[ScanBuffer],
        sequential: bool = False,
        ground_uniforms: Optional[torch.Tensor] = None,
        downsample_uniforms: Optional[torch.Tensor] = None,
    ) -> Tuple[List[ScanBuffer], torch.Tensor]:
        """Process a list of same-capacity single-scan buffers.

        ``sequential=False``: one batched run; every stage covers the B
        scans at once, so each kernel launches as often as for one scan.
        ``sequential=True``: single-scan runs one after another on the
        current stream. ``ground_uniforms`` float32[B, num_iterations,
        ransac_n] and ``downsample_uniforms`` float32[B, capacity] give
        each scan its RANSAC and random-downsampler draws.
        Returns (list of ScanBuffers, planes float32[B, 4]).
        """
        if not bufs:
            return [], torch.zeros((0, 4), dtype=torch.float32, device=self.device)
        start = get_current_time(monotonic=True)

        def per_scan(i):  # scan i's draws, where the caller gave them
            return (None if d is None else d[i] for d in (ground_uniforms, downsample_uniforms))

        if graphs.captures(self.device):
            bufs = list(bufs)
            if sequential:
                draws = [self._draw((), b.capacity, *per_scan(i)) for i, b in enumerate(bufs)]
            else:
                draws = self._draw((len(bufs),), bufs[0].capacity, ground_uniforms,
                                   downsample_uniforms)
            mode = "sequential" if sequential else "vmapped"
            outs, planes = self._replay(mode, bufs, draws)
            if not sequential:
                outs = unstack_buffer(outs)
        elif sequential:
            runs = [self._run(b, self.params, self.generator, *per_scan(i))
                    for i, b in enumerate(bufs)]
            outs, planes = [r[0] for r in runs], torch.stack([r[1] for r in runs])
        else:
            out, planes = self._run(
                stack_buffers(bufs), self.params, self.generator, ground_uniforms,
                downsample_uniforms,
            )
            outs = unstack_buffer(out)
        self.processing_times["preprocessing_time"] = get_time_difference(
            start, get_current_time(monotonic=True)
        )
        return outs, planes

    def _draw(self, batch_shape, capacity, ground_uniforms, downsample_uniforms):
        return draw_uniforms(self.settings, batch_shape, capacity, self.generator, self.device,
                             ground_uniforms, downsample_uniforms)

    def _replay(self, mode: str, bufs, draws):
        """Run ``bufs`` through the captured program of ``mode`` ('scan',
        'vmapped' or 'sequential') for their shapes, capturing it on the
        first call: (buffer or buffers, plane or planes). Its tag is
        ``("engine", mode, settings)``, its inputs ``(bufs, params,
        draws)``."""
        run = self._run

        def make():
            if mode == "scan":
                return lambda b, p, d: run(b, p, None, *d)
            if mode == "vmapped":  # the stack is captured too
                return lambda bs, p, d: run(stack_buffers(bs), p, None, *d)

            def sequential(bs, p, ds):  # the reference's lax.map
                runs = [run(b, p, None, *d) for b, d in zip(bs, ds)]
                return [r[0] for r in runs], torch.stack([r[1] for r in runs])

            return sequential

        args = (bufs, self.params, draws)
        return graphs.program(("engine", mode, self.settings), make, *args)(*args)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_profiled(self, buf: ScanBuffer, ground_uniforms: Optional[torch.Tensor],
                      downsample_uniforms: Optional[torch.Tensor]):
        """The stages one by one, each timed to a sync after it: on a card
        each stage's captured program (tag ``("stage", name, settings)``,
        inputs ``(buf, params, draws)``), else the stage itself."""
        plane = torch.full(
            buf.batch_shape + (4,), float("nan"), dtype=torch.float32, device=buf.device
        )
        graphed = graphs.captures(self.device)
        if graphed:
            draws = self._draw(buf.batch_shape, buf.capacity, ground_uniforms, downsample_uniforms)
        self._sync()
        for name, fn in stage_functions(self.settings, separate_stages=True):
            with self._timer.stage(STAGE_TIMING_KEYS[name]):
                if graphed:
                    args = (buf, self.params, draws)
                    buf, aux = graphs.program(
                        ("stage", name, self.settings),
                        lambda fn=fn: lambda b, p, d: fn(b, p, None, *d), *args)(*args)
                else:
                    buf, aux = fn(buf, self.params, self.generator, ground_uniforms,
                                  downsample_uniforms)
                self._sync()
            if aux is not None:
                plane = aux
        return buf, plane

    # -- introspection --------------------------------------------------------

    def count(self, buf: ScanBuffer) -> int:
        return int(valid_count(buf))
