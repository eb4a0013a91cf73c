"""Proposal and classification networks (eval only)."""
