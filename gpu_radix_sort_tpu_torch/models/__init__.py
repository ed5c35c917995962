"""Execution pipelines."""
