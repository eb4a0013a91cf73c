"""Batched detection."""
