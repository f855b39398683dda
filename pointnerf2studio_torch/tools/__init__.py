"""Command-line tools of the port (run each with `python -m`)."""
