"""Serving driver."""
