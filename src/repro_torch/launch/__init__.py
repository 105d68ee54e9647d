"""Launchers: the serving entry point."""
