"""Execution pipelines."""

from .pipelines import (  # noqa: F401
    DistributedSortPipeline,
    FullSortPipeline,
    HashAggregatePipeline,
    PartialSortPipeline,
)
