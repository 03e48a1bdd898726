"""Metric logging, progress and model summaries of the port."""
