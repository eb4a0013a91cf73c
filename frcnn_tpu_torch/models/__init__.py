"""Proposal and classification networks."""
