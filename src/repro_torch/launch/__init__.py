"""Launchers: the serving loop (``serve``)."""
