"""Evaluation metrics of the port."""
