"""Synthetic federated datasets (no download)."""
