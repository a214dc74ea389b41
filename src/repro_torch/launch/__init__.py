"""Launchers: the serving and training entry points."""
