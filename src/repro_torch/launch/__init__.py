"""Launchers of the port: ``serve`` (prefill + decode loop)."""
