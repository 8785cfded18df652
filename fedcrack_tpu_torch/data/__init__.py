"""Synthetic fixtures and the uint8 transport encoding."""
