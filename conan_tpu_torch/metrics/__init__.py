"""Objective evaluation metrics of the port."""
