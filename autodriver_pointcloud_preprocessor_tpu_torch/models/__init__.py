"""Pipeline models: the preprocessing pipeline, its named presets, and the
``Preprocessor`` engine."""
from .pipeline import (
    STAGE_TIMING_KEYS,
    PipelineParams,
    PipelineSettings,
    build_pipeline,
    params_from_config,
    pipeline_runner,
    settings_from_config,
    stage_functions,
)
from .preprocessor import Preprocessor
