"""Data-processing pipeline (ref: pipelines/data_processing/pipeline.py:4-21)."""

from ai_music_generation_tpu_torch.project.framework import Pipeline, node

from .nodes import process_data


def create_pipeline() -> Pipeline:
    return Pipeline([
        node(process_data, inputs=["test_run_data", "params:data_processing.drop_duplicates"], outputs="processed_data",
             name="process_data_node"),
    ])
