"""Command-line entry points (``nrtorch-serve``)."""
